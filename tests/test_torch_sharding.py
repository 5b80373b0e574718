"""The port's sharding rules and meshes against the JAX package's.

For every leaf of the ten full configs' parameters (``jax.eval_shape``
of the JAX ``init_params``) and decode states (``init_decode_state`` at
decode_32k's batch and length), the port's ``param_sharding`` and
``state_sharding`` give the JAX functions' specs, entry by entry, under
both policies on the (1, 1), (16, 16) and (2, 16, 16) meshes.  The port
resolves against a ``FleetMesh`` that repeats the CPU; the JAX package
resolves with its ``_mesh_axes`` patched to the same names and sizes
(a JAX mesh of 256 devices cannot be made in a test process, and
``use_abstract_mesh`` refuses a size change once another test installed
a mesh).
"""
import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs
from repro.distributed import sharding as JS
from repro.models import init_decode_state
from repro.models import init_params as jax_init_params
from repro_torch.distributed import sharding as PS
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = sorted(JS.POLICIES)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_process_mesh():
    PS.set_mesh(None)
    yield
    PS.set_mesh(None)


def _path_str(path):
    """A leaf's path string, as ``repro/launch/dryrun.py`` builds it."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@functools.lru_cache(maxsize=None)
def leaves(arch, kind):
    """(path, shape) of every leaf of ``arch``'s full config: its
    parameters, or its decode state at decode_32k (B 128, 32768)."""
    cfg = get_config(arch)
    if kind == "params":
        tree = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                      cfg))
    else:
        src = 32768 if cfg.encoder_decoder else 0
        tree = jax.eval_shape(lambda: init_decode_state(cfg, 128, 32768,
                                                        src_len=src))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return tuple((_path_str(p), tuple(x.shape)) for p, x in flat)


def cpu_mesh(name):
    shape, axes = MESHES[name]
    devs = np.empty(shape, dtype=object)
    devs.reshape(-1)[:] = [CPU] * devs.size
    return PS.FleetMesh(devs, axes)


def jax_resolve(fn, calls, mesh, policy):
    """``fn(*args)`` of the JAX package for each of ``calls`` on a mesh
    of ``MESHES[mesh]``, under ``policy``; specs as tuples."""
    shape, axes = MESHES[mesh]
    present = (set(axes), dict(zip(axes, shape)))
    with mock.patch.object(JS, "_mesh_axes", lambda: present), \
            JS.with_logical_rules(JS.POLICIES[policy]):
        out = [fn(*args) for args in calls]
    return [None if s is None else tuple(s) for s in out]


def port_resolve(fn, calls, mesh, policy):
    with cpu_mesh(mesh), PS.with_logical_rules(PS.POLICIES[policy]):
        out = [fn(*args) for args in calls]
    assert all(isinstance(s, PS.PartitionSpec) for s in out)
    return out


def test_the_policies_are_the_reference_rules():
    assert PS.POLICIES == JS.POLICIES
    assert PS.LOGICAL_RULES == JS.LOGICAL_RULES


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_param_sharding_matches_jax_on_every_leaf(arch, mesh, policy):
    calls = leaves(arch, "params")
    got = port_resolve(PS.param_sharding, calls, mesh, policy)
    want = jax_resolve(JS.param_sharding, calls, mesh, policy)
    assert got == want, [(c, g, w) for c, g, w in zip(calls, got, want)
                         if g != w]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_state_sharding_matches_jax_on_every_leaf(arch, mesh, policy):
    calls = leaves(arch, "state")
    got = port_resolve(PS.state_sharding, calls, mesh, policy)
    want = jax_resolve(JS.state_sharding, calls, mesh, policy)
    assert got == want, [(c, g, w) for c, g, w in zip(calls, got, want)
                         if g != w]


# logical_to_spec's rules one at a time: (logical names, shape)
LOGICAL_CASES = {
    "embedding_rows_fall_back_to_a_prefix": (("vocab", "fsdp"),
                                             (151936, 2048)),
    "flat_fsdp_prefix": (("fsdp",), (151936,)),
    "tuple_of_logical_names": ((("batch", "fsdp"), "ff"), (512, 4096)),
    "used_axes_not_reused": (("ff", "heads", "fsdp", "fsdp"),
                             (4096, 32, 2048, 2048)),
    "trailing_nones_kept": (("batch", None, None), (256, 7, 9)),
    "odd_dims_replicate": (("batch", "heads", "ff"), (3, 14, 5)),
    "no_shape_no_fallback": (("batch", "kv_heads", "replicated"), None),
    "unknown_name_replicates": (("no_such_axis", "ff"), (16, 16)),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", LOGICAL_CASES)
def test_logical_to_spec_matches_jax(case, mesh, policy):
    logical, shape = LOGICAL_CASES[case]
    call = [(logical, shape)]

    def jax_fn(lg, sh):
        return JS.logical_to_spec(*lg, shape=sh)

    def port_fn(lg, sh):
        return PS.logical_to_spec(*lg, shape=sh)
    assert (port_resolve(port_fn, call, mesh, policy)
            == jax_resolve(jax_fn, call, mesh, policy))


def test_logical_to_spec_fallbacks_by_value():
    with cpu_mesh("16x16"):
        # a stacked wq: FSDP on d, heads over "model"; 60 experts do not
        # divide 16 ways, so they replicate and "model" goes to f; under
        # zero3 151936 rows do not divide 256 ways and keep the prefix
        assert PS.param_sharding("blocks/0/mixer/wq",
                                 (24, 2048, 16, 128)) == (
            None, "data", "model", None)
        assert PS.param_sharding("blocks/0/mlp/expert_gate",
                                 (60, 2048, 1408)) == (None, "data", "model")
        with PS.with_logical_rules(PS.POLICIES["zero3"]):
            assert PS.logical_to_spec("fsdp", shape=(151936,)) == ("data",)
            assert PS.logical_to_spec("fsdp", shape=(4096,)) == (
                ("data", "model"),)
        assert PS.logical_to_spec("ff", "heads") == ("model", None)
        assert PS.logical_to_spec("batch", None, None) == ("data", None,
                                                           None)


def test_without_a_mesh_nothing_resolves():
    assert PS.active_mesh() is None
    assert PS.logical_to_spec("batch", "ff") is None
    assert PS.param_sharding("blocks/0/mixer/wq", (16, 4, 8)) is None
    assert PS.state_sharding("blocks/0/k", (2, 4, 16, 4, 8)) is None
    assert PS.mesh_axis_size("model") == 1 and PS.heads_shardable(7)


def test_mesh_axis_size_and_heads_shardable():
    with cpu_mesh("2x16x16"):
        assert [PS.mesh_axis_size(a) for a in ("pod", "data", "model",
                                               "other")] == [2, 16, 16, 1]
        assert PS.heads_shardable(32) and not PS.heads_shardable(14)
    with cpu_mesh("1x1"):
        assert PS.mesh_axis_size("model") == 1 and PS.heads_shardable(14)


def test_nested_rules_restore_the_outer_rules():
    with cpu_mesh("16x16"):
        with PS.with_logical_rules({"ff": ("data",)}):
            assert PS.logical_to_spec("ff") == ("data",)
            with PS.with_logical_rules(PS.POLICIES["zero3"]):
                assert PS.logical_to_spec("ff", "batch") == (
                    None, ("data", "model"))
                assert PS._rules()["fsdp"] == ("data", "model")
            assert PS.logical_to_spec("ff", "batch") == ("data", None)
        assert PS._rules() is PS.LOGICAL_RULES
        assert PS.logical_to_spec("ff") == ("model",)


def test_set_mesh_installs_and_clears():
    mesh = make_host_mesh(device="cpu")
    assert PS.set_mesh(mesh) is mesh
    assert PS.active_mesh() is mesh
    assert PS.logical_to_spec("ff") == ("model",)
    with cpu_mesh("16x16") as inner:          # a context wins over it
        assert PS.active_mesh() is inner
    assert PS.active_mesh() is mesh
    PS.set_mesh(None)
    assert PS.active_mesh() is None
    assert PS.logical_to_spec("ff") is None
    with pytest.raises(TypeError):
        PS.set_mesh("data")


def test_constrain_is_the_identity_on_one_device():
    x = torch.ones(4, 8)
    assert PS.constrain(x, "batch", "ff") is x       # no mesh
    for name in MESHES:                              # one distinct device
        with cpu_mesh(name):
            assert PS.constrain(x, "batch", "ff", "heads") is x


def test_constrain_refuses_more_than_one_device():
    x = torch.ones(4, 8)
    two = PS.FleetMesh([["cuda:0"], ["cuda:1"]], ("data", "model"))
    with two, pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        PS.constrain(x, "batch", "ff")


def test_host_mesh_and_production_mesh():
    mesh = make_host_mesh(device="cpu")
    assert mesh.devices.shape == (1, 1)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices[0, 0] == CPU
    # fewer CUDA devices than 256 (or 512) here: both raise, as
    # jax.make_mesh does
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="devices"):
            make_production_mesh(multi_pod=multi_pod)
