"""Shared helpers of the PyTorch port's differential tests.

Each test builds its inputs once with numpy and hands the same arrays to
the JAX package and to the port (``device="cpu"``, float64).
"""
import numpy as np
import torch

from repro_torch.convert import speedup_from_arrays


def port_speedup(sp, s_fn=None, ds_fn=None):
    """The port's copy of a JAX speedup, built from its leaves."""
    kind = type(sp).__name__
    if kind == "GenericSpeedup":
        return speedup_from_arrays(kind, B=sp.B, s_fn=s_fn, ds_fn=ds_fn,
                                   inv_iters=sp.inv_iters, device="cpu")
    sigma = sp.sigma if isinstance(sp.sigma, int) else np.asarray(sp.sigma)
    return speedup_from_arrays(kind, A=np.asarray(sp.A), w=np.asarray(sp.w),
                               gamma=np.asarray(sp.gamma), sigma=sigma,
                               B=sp.B, device="cpu")


def jax_sharded(fn, *args, mesh, **kw):
    """Call the JAX package's sharded ``fn`` with ``mesh`` installed as the
    context mesh for the call.  On jax 0.9 ``set_mesh(None)`` raises, so
    a mesh that another test in the process installed
    (``tests/distributed/test_sharding.py``) stays installed, and
    ``shard_map`` refuses a mesh other than the context's; the context
    form works after such a leak."""
    import jax
    with jax.sharding.set_mesh(mesh):
        return fn(*args, mesh=mesh, **kw)


def t64(x):
    """numpy → CPU float64 tensor (bool arrays stay bool)."""
    x = np.array(x)
    return torch.as_tensor(x, dtype=torch.bool if x.dtype == bool
                           else torch.float64)


def np_(x):
    """JAX array or tensor → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_sim_match(out, ref, rtol=1e-6, B=10.0):
    """Two SimResults agree: J, T, ``n_events`` and every event's time and
    allocations (``tests/core/test_simulator.py::_assert_match``)."""
    assert np.isfinite(ref.J)
    assert abs(out.J - ref.J) / max(ref.J, 1e-12) < rtol
    np.testing.assert_allclose(out.T, ref.T, rtol=rtol, atol=rtol)
    assert out.n_events == ref.n_events
    for (to, tho), (tr, thr) in zip(out.events, ref.events):
        assert abs(to - tr) <= rtol * max(1.0, tr)
        np.testing.assert_allclose(np_(tho), np_(thr), atol=rtol * B)
