"""The port's placements over a mesh: ``sharding.spec_to_placements``,
``convert.port_leaf_spec`` and ``constrain`` on ``DTensor``s.

For every parameter of the ten full configs (built on meta), on both
production meshes and under both policies, the port's spec is the JAX
package's ``param_sharding`` spec of the same leaf (resolved by the JAX
package itself, its mesh axes patched in as ``tests/
test_torch_sharding.py`` does) with the stacked axes dropped and an
attention projection's (H, hd) merged into its flattened axis; and the
placements shard, on each mesh axis, the port dimension that the JAX
spec shards there, a dimension over several axes major-first in mesh
order, as a JAX ``PartitionSpec`` splits it.  ``constrain`` is held on a
(2, 4) mesh of ``DTensor``s with meta shards under a fake process group
(``launch/dryrun.device_mesh_of``), and as the identity at one device.
No trace runs here.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.distributed import sharding as JS
from repro_torch.configs import get_config
from repro_torch.convert import jax_leaf_paths, port_leaf_spec, \
    port_param_specs
from repro_torch.distributed import sharding as PS
from repro_torch.launch.dryrun import device_mesh_of, place
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Transformer

POLICIES = sorted(JS.POLICIES)
MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(autouse=True)
def no_process_mesh():
    PS.set_mesh(None)
    yield
    PS.set_mesh(None)


@functools.lru_cache(maxsize=None)
def meta_model(arch):
    cfg = get_config(arch)
    return cfg, Transformer(cfg, device="meta", dtype=torch.float32,
                            trainable=True)


def jax_specs(calls, mesh, policy):
    """The JAX package's ``param_sharding`` of (path, shape) ``calls`` on
    ``mesh``'s axes under ``policy``, one entry a dimension."""
    present = (set(mesh.axis_names), mesh.shape)
    with mock.patch.object(JS, "_mesh_axes", lambda: present), \
            JS.with_logical_rules(JS.POLICIES[policy]):
        out = [tuple(JS.param_sharding(p, s) or ()) for p, s in calls]
    return [s + (None,) * (len(shape) - len(s))
            for s, (_, shape) in zip(out, calls)]


def _axes(entry):
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def port_dims(name, stacked, ndim):
    """For each dimension of the JAX leaf, the port leaf's dimension it
    becomes (the stacked ones None; (H, hd) both the flattened one)."""
    leaf = name.split(".")[-1]
    dims = [None] * stacked + list(range(ndim - stacked))
    if leaf in ("wq", "wk", "wv"):
        dims[-1] = dims[-2]
    elif leaf in ("wo", "bq", "bk", "bv"):
        dims[stacked + 1:] = [d - 1 for d in dims[stacked + 1:]]
    return dims


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", list_archs())
def test_leaf_specs_and_placements_follow_param_sharding(arch, policy,
                                                         mesh_name):
    assert jax_config(arch).d_model == get_config(arch).d_model
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name], device="meta")
    cfg, model = meta_model(arch)
    paths = jax_leaf_paths(cfg, model)
    names = list(paths)
    js = dict(zip(names, jax_specs([paths[n][:2] for n in names], mesh,
                                   policy)))
    with mesh, PS.with_logical_rules(PS.POLICIES[policy]):
        specs = port_param_specs(cfg, model)
    params = dict(model.named_parameters())
    for name in names:
        path, shape, stacked = paths[name]
        spec = specs[name]
        assert spec == port_leaf_spec(path, js[name], stacked)
        assert len(spec) in (0, params[name].ndim), (name, spec)
        placements = PS.spec_to_placements(spec, mesh.axis_names)
        dims = port_dims(name, stacked, len(shape))
        for i, ax in enumerate(mesh.axis_names):
            jdims = [d for d, e in enumerate(js[name]) if ax in _axes(e)]
            assert len({dims[d] for d in jdims}) <= 1 and None not in {
                dims[d] for d in jdims}, (name, js[name])
            want = Shard(dims[jdims[0]]) if jdims else Replicate()
            assert placements[i] == want, (name, ax, js[name], placements)
        # several axes on one dimension: major first, in mesh order
        for entry in spec:
            idx = [mesh.axis_names.index(a) for a in _axes(entry)]
            assert idx == sorted(idx), (name, entry)


def test_spec_to_placements_refuses_an_axis_order_jax_would_split_otherwise():
    axes = ("pod", "data", "model")
    assert PS.spec_to_placements(PS.PartitionSpec(("pod", "model"), None),
                                 axes) == [Shard(0), Replicate(), Shard(0)]
    assert PS.spec_to_placements(PS.PartitionSpec(), axes) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        PS.spec_to_placements(PS.PartitionSpec(("model", "data")), axes)
    # a sharded head width (a bias's generic rule) joins the heads' axes
    assert port_leaf_spec("blocks/0/mixer/bq", (None, "data", "model"), 1) \
        == PS.PartitionSpec(("data", "model"))


def test_constrain_redistributes_a_dtensor_and_is_the_identity_at_one_device():
    devs = np.empty((2, 4), dtype=object)
    devs[:] = torch.device("meta")
    mesh = PS.FleetMesh(devs, ("data", "model"))
    x_plain = torch.ones(4, 8)
    with make_host_mesh("cpu"):
        assert PS.constrain(x_plain, "batch", "ff") is x_plain
    with device_mesh_of(mesh) as dm, mesh, \
            PS.with_logical_rules(PS.POLICIES["dp_tp"]):
        x = place(torch.empty(8, 16, device="meta"), dm, ("data", None))
        y = PS.constrain(x, "batch", "ff")
        assert y is not x and tuple(y.placements) == (Shard(0), Shard(1))
        assert y.to_local().shape == (4, 4) and y.shape == x.shape
        assert PS.constrain(y, "batch", "ff") is y     # already placed
        z = PS.constrain(y, "batch", None)
        assert tuple(z.placements) == (Shard(0), Replicate())
        # a plain tensor over several distinct devices still raises
        two = PS.FleetMesh([["cuda:0"], ["cuda:1"]], ("data", "model"))
        with two, pytest.raises(NotImplementedError, match="ROADMAP item 9"):
            PS.constrain(x_plain, "batch", "ff")
    assert not torch.distributed.is_initialized()
