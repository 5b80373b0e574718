"""The port's elastic reallocation (``repro_torch/sched/elastic.py``)
against the JAX package's (``repro/sched/elastic.py``).

On the llama smoke config (float32), from the same weights (the JAX
``init_params(PRNGKey(0))`` through ``params_from_arrays``) and the
same batches, both packages train 3 steps and reallocate 8 → 4 chips:
each side's restored leaves equal its leaves before the move bit for
bit, each of the port's placements carries the spec the JAX
``_shardings`` gives the same leaf (a leaf the JAX tree stacks over the
block pattern's repeats compared without its leading entries, and an
attention projection, which the port stores flattened, with its (H, hd)
entries merged into the heads' one), and the
resumed step's loss equals JAX's at atol 2e-4 and rtol 1e-3 (the
tolerance of the port's training tests against the JAX package's).
The JAX ``ElasticTrainer`` installs a mesh, so it runs inside
``jax_sharded``; the port's draws its meshes from the CPU here, where it
draws them from the CUDA cards by default.
"""
import math
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticTokens as JaxTokens
from repro.data import host_batch_iterator as jax_batches
from repro.models import init_params as jax_init_params
from repro.sched import elastic as JE
from repro_torch.sched import elastic as PE
from repro.train import AdamWConfig as JaxAdamW
from repro.train import TrainState as JaxState
from repro.train import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.convert import jax_leaf_paths, params_from_arrays
from repro_torch.data import SyntheticTokens, host_batch_iterator
from repro_torch.distributed.sharding import (FleetMesh, NamedSharding,
                                              PartitionSpec, active_mesh,
                                              set_mesh)
from repro_torch.sched import ElasticTrainer, ReallocEvent, mesh_for_chips
from repro_torch.train import (AdamWConfig, TrainState, checkpoint as ckpt,
                               make_train_step)
from torch_port_util import jax_sharded

ARCH = "llama3.2-1b"
CPU = torch.device("cpu")
STEPS, OLD, NEW = 3, 8, 4
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True)
def no_process_mesh():
    set_mesh(None)
    yield
    set_mesh(None)


def most_square(n):
    """(data, model) with data · model = n, model ≤ data, model largest."""
    m = max(k for k in range(1, n + 1) if n % k == 0 and k * k <= n)
    return n // m, m


def test_mesh_for_chips_factorization():
    devices = [CPU] * 512
    for n in range(1, 513):
        mesh = mesh_for_chips(n, devices)
        assert mesh.devices.shape == most_square(n), n
        assert mesh.axis_names == ("data", "model")
        assert math.prod(mesh.devices.shape) == n
    # more chips than devices: the mesh takes every device
    assert mesh_for_chips(64, [CPU] * 6).devices.shape == (3, 2)
    # against the JAX function, on the devices JAX has here
    have = len(jax.devices())
    for n in (1, 2, 3, 4, 6, 8, 64, 128):
        jm = JE.mesh_for_chips(n)
        assert mesh_for_chips(n, [CPU] * have).devices.shape == \
            jm.devices.shape
        assert jm.axis_names == ("data", "model")


def test_mesh_for_chips_takes_the_cards_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_for_chips(4)


@pytest.fixture(scope="module")
def both_moved(tmp_path_factory):
    """3 steps then a move of 8 → 4 chips in both packages: the values
    before the move, the states after it, the trainers and the meshes,
    and each side's next loss."""
    jcfg = jax_config(ARCH, smoke=True)
    pcfg = get_config(ARCH, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    jstep = jax.jit(jax_train_step(jcfg, JaxAdamW(lr=1e-3,
                                                  warmup_steps=1)))
    pstep = make_train_step(pcfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    js = JaxState.create(jax.tree_util.tree_map(jax.numpy.asarray, tree))
    ps = TrainState.create(params_from_arrays(pcfg, tree, device=CPU,
                                              dtype=torch.float32,
                                              trainable=True))
    jit_ = jax_batches(JaxTokens(vocab=jcfg.vocab, seq_len=32,
                                 global_batch=4), jcfg)
    pit = host_batch_iterator(SyntheticTokens(vocab=pcfg.vocab, seq_len=32,
                                              global_batch=4), pcfg)
    for _ in range(STEPS):
        js.params, js.opt_state, _ = jstep(js.params, js.opt_state,
                                           next(jit_))
        js.step += 1
        ps.params, ps.opt_state, _ = pstep(ps.params, ps.opt_state,
                                           next(pit))
        ps.step += 1
    j_before = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state))]
    p_before = ({k: v.detach().clone() for k, v in
                 ps.params.named_parameters()},
                {k: v.clone() for k, v in ps.opt_state.mu.items()},
                {k: v.clone() for k, v in ps.opt_state.nu.items()},
                ps.opt_state.step.clone())

    jt = JE.ElasticTrainer(jcfg, lambda mesh: jstep,
                           str(tmp_path_factory.mktemp("jax")))
    jmesh, js = jax_sharded(
        lambda mesh: jt.reallocate(js, old_chips=OLD, new_chips=NEW),
        mesh=JE.mesh_for_chips(1))
    pt = ElasticTrainer(pcfg, lambda mesh: pstep,
                        str(tmp_path_factory.mktemp("port")))
    with mock.patch.object(PE, "_cards", lambda: [CPU]):
        pmesh, ps = pt.reallocate(ps, old_chips=OLD, new_chips=NEW)
    # the port's AdamW updates in place, so its leaves are read now
    p, mu, nu, step = p_before
    p_same = ([(v.device, torch.equal(v, p[k]))
               for k, v in ps.params.named_parameters()]
              + [(v.device, torch.equal(v, mu[k]))
                 for k, v in ps.opt_state.mu.items()]
              + [(v.device, torch.equal(v, nu[k]))
                 for k, v in ps.opt_state.nu.items()]
              + [(ps.opt_state.step.device,
                  torch.equal(ps.opt_state.step, step))])
    tree_p = {"params": ps.params, "opt": ps.opt_state}
    shardings = (jax_sharded(lambda mesh: jt._shardings(
        jmesh, {"params": js.params, "opt": js.opt_state}), mesh=jmesh),
        pt._shardings(pmesh, tree_p))
    jb = next(jax_batches(JaxTokens(vocab=jcfg.vocab, seq_len=32,
                                    global_batch=4), jcfg,
                          start_step=STEPS))
    pb = next(host_batch_iterator(SyntheticTokens(
        vocab=pcfg.vocab, seq_len=32, global_batch=4), pcfg,
        start_step=STEPS))
    _, _, jm = jstep(js.params, js.opt_state, jb)
    _, _, pm = pstep(ps.params, ps.opt_state, pb)
    return {"j_before": j_before, "p_same": p_same, "js": js, "ps": ps,
            "jt": jt, "pt": pt, "pmesh": pmesh, "shardings": shardings,
            "losses": (float(jm["loss"]), float(pm["loss"])),
            "cfg": pcfg, "active_after": active_mesh()}


def test_reallocate_restores_every_leaf_bit_for_bit(both_moved):
    r = both_moved
    # the port: every parameter, moment and the step, on the new mesh's
    # device, equal to its value before the move
    n = len(list(r["ps"].params.parameters()))
    assert len(r["p_same"]) == 3 * n + 1
    assert all(dev == CPU and same for dev, same in r["p_same"])
    # the JAX package: its next step returned new trees, so the state
    # still holds what the move restored
    after = jax.tree_util.tree_leaves((r["js"].params, r["js"].opt_state))
    assert len(after) == len(r["j_before"])
    for a, b in zip(r["j_before"], after):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_reallocate_records_its_event(both_moved):
    r = both_moved
    assert r["jt"].events and r["jt"].events[0].new_chips == NEW
    assert len(r["pt"].events) == 1
    ev = r["pt"].events[0]
    assert isinstance(ev, ReallocEvent)
    assert (ev.old_chips, ev.new_chips) == (OLD, NEW)
    assert ev.ckpt_path.endswith(f"step_{STEPS:08d}") and ev.restore_s > 0
    _, manifest = ckpt.restore(ev.ckpt_path, {
        "params": r["ps"].params, "opt": r["ps"].opt_state})
    assert manifest["extra"] == {"reason": "realloc", "old": OLD,
                                 "new": NEW}
    assert r["pmesh"].devices.shape == (1, 1)
    assert r["active_after"] is r["pmesh"]       # set_mesh, as in JAX


def _jax_spec_at(tree, path):
    node = tree
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, (tuple, list)) else node[k]
    return node


def _flattened(path, spec):
    """A JAX attention projection's spec on the port's flattened leaf:
    (d, H, hd) → (d, H·hd), (H, hd, d) → (H·hd, d), (H, hd) → (H·hd,);
    the head width is never sharded."""
    name = path.split("/")[-1]
    if name in ("wq", "wk", "wv"):
        assert spec[2] is None
        return spec[:2]
    if name == "wo":
        assert spec[1] is None
        return (spec[0], spec[2])
    if name in ("bq", "bk", "bv"):
        assert spec[1] is None
        return spec[:1]
    return spec


def test_placements_carry_the_jax_specs(both_moved):
    r = both_moved
    jsh, psh = r["shardings"]
    paths = jax_leaf_paths(r["cfg"], r["ps"].params)
    assert sorted(psh["params"]) == sorted(paths)
    for name, (path, shape, stacked) in paths.items():
        js = tuple(_jax_spec_at(jsh["params"], path).spec)
        # JAX's spec has one entry a dimension, trailing Nones included
        js = js + (None,) * (len(shape) - len(js))
        got = psh["params"][name]
        assert isinstance(got, NamedSharding) and got.mesh is r["pmesh"]
        assert tuple(got.spec) == _flattened(path, js[stacked:]), (name,
                                                                   path)
        assert got.device == CPU
    for moment in ("mu", "nu"):
        for name, got in getattr(psh["opt"], moment).items():
            path = paths[name][0]
            js = tuple(_jax_spec_at(getattr(jsh["opt"], moment), path).spec)
            js = js + (None,) * (len(paths[name][1]) - len(js))
            assert tuple(got.spec) == _flattened(path,
                                                 js[paths[name][2]:])
    assert tuple(psh["opt"].step.spec) == tuple(jsh["opt"].step.spec) == ()


def test_resumed_loss_matches_jax(both_moved):
    jl, pl = both_moved["losses"]
    assert np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, atol=ATOL, rtol=RTOL)


def test_restore_over_an_axis_of_two_raises(tmp_path):
    path = ckpt.save(str(tmp_path), 1, {"a": torch.arange(4.0),
                                         "b": torch.ones(2)})
    devs = np.empty((2, 1), dtype=object)
    devs[:] = [[CPU], [CPU]]
    mesh = FleetMesh(devs, ("data", "model"))
    template = {"a": torch.zeros(4), "b": torch.zeros(2)}
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        ckpt.restore(path, template, shardings={
            "a": NamedSharding(mesh, PartitionSpec("data")),
            "b": NamedSharding(mesh, PartitionSpec())})
    # replicated over the same mesh: the one device holds it
    out, _ = ckpt.restore(path, template, shardings={
        "a": NamedSharding(mesh, PartitionSpec(None)),
        "b": NamedSharding(mesh, PartitionSpec())})
    assert torch.equal(out["a"], torch.arange(4.0))


def test_restore_moves_a_module_to_its_placement(tmp_path):
    """A module's parameters move to the placement's device, then fill:
    a template on meta comes back on the CPU with the saved values."""
    lin = torch.nn.Linear(3, 2)
    path = ckpt.save(str(tmp_path), 1, {"m": lin})
    on_meta = torch.nn.Linear(3, 2, device="meta")
    mesh = mesh_for_chips(1, [CPU])
    out, _ = ckpt.restore(path, {"m": on_meta}, shardings={"m": {
        n: NamedSharding(mesh) for n, _ in on_meta.named_parameters()}})
    assert out["m"] is on_meta
    for (n, a), (_, b) in zip(on_meta.named_parameters(),
                              lin.named_parameters()):
        assert a.device == CPU and torch.equal(a, b), n
