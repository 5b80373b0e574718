"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's, on the smoke configs of llama3.2-1b and qwen2-moe-a2.7b (the
MoE's expert occupancy is counted on meta).

The JAX side is built here from ``make_train_step`` and read through
``analyze_hlo``'s ``top_contributors`` on the compiled HLO:
``repro.launch.dryrun`` is not imported, since it asks XLA for 512
devices when it is imported.  Over a mesh, the JAX side is the committed
record of ``tools/dryrun_reference.py`` (the reference's ``run_cell`` on
a (2, 4) mesh of host devices, which cannot be made in a test process).

Tolerance: the port's train-step product flops outside attention
(``top_contributors`` of the meta trace, "flops", less the K5
stand-ins' rows) are held to the JAX HLO's dot flops outside attention
within 5%; they read 1.0 (llama) and 1.041 (qwen2-moe) at 2 × 64 tokens.
The attention's products are held exactly to each side's own rule: the
JAX blocked attention (``flash_attention_xla``, the dots nested in its
block scans) at 20·hd a (query, key) pair of its one 64-row block (the
forward, the layer's remat, its checkpointed blocks' recompute and
backward; 22·hd with more than one block, as the (2, 4) record reads),
and K5's stand-ins (``kernels/flash_attention/meta.py``) at 4·hd a pair
of every tile they visit in the forward, twice (the layer's remat runs
it again), and 18·hd in the backward.  What accounts for the rest of
the products: the port's MoE router runs one more small product in its
backward.  Both sides run the cross-entropy's logits product four
times a chunk (forward, remat recompute, two in the backward) once the
scan over chunks has two trips or more, as every train shape has
(train_4k: 8 of 512); with one chunk, XLA drops the single trip's
recompute, and qwen2-moe's untied 512-row unembedding then reads
1.0625.  So the steps run with ``ce_chunk`` 32: two chunks of the 64
tokens.
"""
import ast
import dataclasses
import json
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import get_config as jax_config
from repro.launch.hlo_analysis import top_contributors as jax_top
from repro.models import init_params as jax_init_params
from repro.train import AdamWConfig as JaxAdamW
from repro.train import adamw_init as jax_adamw_init
from repro.train import make_train_step as jax_train_step
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.distributed.sharding import FleetMesh, active_mesh
from repro_torch.launch import dryrun
from repro_torch.kernels.flash_attention.meta import k5_product_flops
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch.hlo_analysis import (host_ops_pass, top_contributors,
                                             trace_program)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Transformer, init_params
from repro_torch.models import attention as attention_mod
from repro_torch.models.moe import MoE, _router, moe_init
from repro_torch.sched.speedup_models import calibrate_from_dryrun
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               make_train_step)

ARCHS = ("llama3.2-1b", "qwen2-moe-a2.7b")
B, S, CE_CHUNK = 2, 64, 32
DOT_RTOL = 0.05
CPU = torch.device("cpu")
REFERENCE = (Path(__file__).resolve().parents[1]
             / "src" / "repro" / "launch" / "dryrun.py")


def reference_keys():
    """The keys of the record the reference's ``run_cell`` returns, read
    from its source (importing it would change XLA's device count)."""
    tree = ast.parse(REFERENCE.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    res = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "res")
    return {k.value for k in res.value.keys}


def jax_dot_flops(arch):
    """(all dot flops, the attention's) of the JAX train step's HLO: the
    attention's are the dots nested in two loops or more (the layer scan
    and the attention's block scans)."""
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              ce_chunk=CE_CHUNK)
    params = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    cfg))
    opt = jax.eval_shape(lambda: jax_adamw_init(params))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    txt = jax.jit(jax_train_step(cfg, JaxAdamW())).lower(
        params, opt, batch).compile().as_text()
    rows = jax_top(txt, "flops", k=10 ** 7)
    return (sum(r[0] for r in rows),
            sum(r[0] for r in rows if r[4].count("while/") >= 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_dot_flops_match_jax(arch):
    cfg = get_config(arch, smoke=True).replace(ce_chunk=CE_CHUNK)
    model = Transformer(cfg, device="meta", dtype=torch.float32,
                        trainable=True)
    opt = adamw_init(dict(model.named_parameters()))
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    rows = top_contributors(make_train_step(cfg, AdamWConfig()), model, opt,
                            batch, metric="flops", k=10 ** 7)
    attn = sum(r[0] for r in rows if r[2] in ("k5_fwd", "k5_bwd"))
    assert {r[2] for r in rows} <= {"mm", "bmm", "addmm", "baddbmm",
                                    "k5_fwd", "k5_bwd"}
    ref, ref_attn = jax_dot_flops(arch)
    # one 64-row block and one 64-key tile: K5's f32 walk and its FMA
    # backward visit every pair; JAX computes every pair of its block
    pairs = B * cfg.n_heads * S * S * cfg.n_layers
    assert attn == (4 + 4 + 18) * cfg.head_dim * pairs
    assert ref_attn == 20 * cfg.head_dim * pairs
    port = sum(r[0] for r in rows) - attn
    assert abs(port / (ref - ref_attn) - 1.0) < DOT_RTOL, (
        port, ref - ref_attn, port / (ref - ref_attn))


@pytest.mark.parametrize("arch, shape_name", [
    ("llama3.2-1b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k")])
def test_run_cell_returns_the_reference_record(arch, shape_name, tmp_path):
    cfg = get_config(arch, smoke=True)
    mesh = make_host_mesh(CPU)
    hlo = tmp_path / "rows.jsonl"
    res = dryrun.run_cell(arch, shape_name, mesh, verbose=False,
                          hlo_out=str(hlo), cfg=cfg)
    assert reference_keys() <= set(res)
    shape = SHAPES[shape_name]
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                   else 1)
    per_token = 6 if shape.kind == "train" else 2
    assert res["ok"] and res["n_devices"] == 1 and res["mesh"] == "1x1"
    assert res["flops_per_dev"] >= per_token * cfg.active_param_count() \
        * tokens
    assert 0 < res["bytes_fused_per_dev"] <= res["bytes_per_dev"]
    assert res["temp_bytes_per_dev"] > 0 and res["arg_bytes_per_dev"] > 0
    assert res["collective_bytes_per_dev"] == 0.0
    assert 0 < res["useful_flops_ratio"] <= 1
    assert active_mesh() is None            # the caller's mesh put back
    rows = [json.loads(line) for line in hlo.read_text().splitlines()]
    assert rows and rows[0][0] == max(r[0] for r in rows)
    # the example's first step reads the cell back as a speedup
    path = tmp_path / "cells.json"
    path.write_text(json.dumps([res]))
    sp = calibrate_from_dryrun(str(path), B=256.0, device=CPU)[
        (arch, shape_name)]
    s = sp.s(torch.tensor([1.0, 32.0, 256.0], dtype=torch.float64))
    assert bool((s > 0).all()) and bool((s[1:] > s[:-1]).all())


def test_meta_inputs_have_the_real_bytes():
    """``shape_specs``' meta inputs of a train step hold as many bytes as
    the tensors a real run of the same step is given."""
    cfg = get_config("llama3.2-1b", smoke=True)
    shape = ShapeConfig("small", S, B, "train")
    specs = dryrun.shape_specs(cfg, shape, make_host_mesh(CPU))
    step = make_train_step(cfg, AdamWConfig())
    _, mem, _ = trace_program(
        lambda x: step(x["params"], x["opt"], x["batch"]), specs)
    st = TrainState.create(init_params(cfg, torch.Generator().manual_seed(0),
                                       device=CPU, dtype=torch.float32,
                                       trainable=True))
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=S,
                            global_batch=B).batch_at(0)
    opt = st.opt_state
    real = (sum(t.numel() * t.element_size() for t in (
        *st.params.parameters(), opt.step, *opt.mu.values(),
        *opt.nu.values())) + sum(x.nbytes for x in batch.values()))
    assert mem.arg_bytes == real


# a train cell of the smoke configs' size for the tests over a mesh: 512
# rows divide both production meshes, and 256 tokens run one
# cross-entropy chunk
SMALL = ShapeConfig("train_small", 256, 512, "train")


def smoke_cells():
    """The dry run with ``train_small`` among its shapes and the smoke
    configs in place of the full ones."""
    return mock.patch.multiple(
        dryrun, SHAPES={**SHAPES, SMALL.name: SMALL},
        get_config=lambda arch: get_config(arch, smoke=True))


def test_a_mesh_of_more_than_one_device_is_not_ok(tmp_path):
    """Once the ROADMAP item 9 refusal, now the cells a mesh of more than
    one device gives: a (2, 1) mesh's, and ``main --multi-pod``'s, are
    ``ok`` with per-device counts (smoke configs).  ``--multi-pod`` runs
    here on the same (2, 1) meta mesh in place of (2, 16, 16): DTensor
    plans a smoke cell's first trace on a 3-D mesh in ~10 s on a CPU, and
    the full production meshes trace in the dry-run tool's own run
    (PERF.md) and in ``test_the_example_cells_trace_on_the_production_
    meshes``."""
    devs = np.empty((2, 1), dtype=object)
    devs[:] = torch.device("meta")
    mesh = FleetMesh(devs, ("data", "model"))
    path = tmp_path / "out.json"
    with smoke_cells():
        res = dryrun.run_cell("deepseek-7b", SMALL.name, mesh, verbose=False)
        assert not torch.distributed.is_initialized()  # its group gone
        with mock.patch.object(dryrun, "make_production_mesh",
                               lambda multi_pod, device: mesh):
            rc = dryrun.main(["--multi-pod", "--arch", "deepseek-7b",
                              "--shape", SMALL.name, "--out", str(path)])
    assert res["ok"] and res["mesh"] == "2x1" and res["n_devices"] == 2
    assert res["collective_bytes_per_dev"] > 0
    cells = json.loads(path.read_text())
    assert rc == 0 and [c["ok"] for c in cells] == [True]
    timed = ("lower_s", "compile_s")
    assert {k: v for k, v in cells[0].items() if k not in timed} == \
        {k: v for k, v in res.items() if k not in timed}
    assert set(res["collective_counts"]) >= {"all-gather", "reduce-scatter"}


def test_moe_occupancy_is_bincounts():
    """The router's expert counts, a sum of ones by ``index_add_``, give
    the load-balance loss bincount's counts give, bit for bit; and the
    router runs on meta."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    m = moe_init(MoE(cfg, device=CPU, dtype=torch.float32), cfg, gen)
    x = torch.randn(300, cfg.d_model, generator=gen)
    _, top_i, aux = _router(m, x, cfg)
    E = cfg.n_experts
    probs = torch.softmax(x.float() @ m.router.float(), dim=-1)
    occupancy = torch.bincount(top_i.reshape(-1), minlength=E).float()
    f_e = occupancy / torch.clamp_min(occupancy.sum(), 1.0)
    assert torch.equal(aux["moe_lb"], E * torch.sum(f_e * probs.mean(0)))
    on_meta = MoE(cfg, device="meta", dtype=torch.float32)
    _, i_meta, aux_meta = _router(on_meta, x.to("meta"), cfg)
    assert i_meta.shape == top_i.shape and aux_meta["moe_lb"].is_meta


# ---- F1: K5's stand-ins on meta ---------------------------------------------
def _shapes_of(fn, *args):
    """Every shape an operation of ``trace_program(fn, *args)`` gives, and
    its ProgramMemory."""
    seen = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            seen.extend(tuple(t.shape) for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor))
            return out

    with Shapes():
        _, mem, _ = trace_program(fn, *args)
    return seen, mem


def test_the_traced_step_holds_no_score_tensor():
    """At S = T = 288, a length that is no width of the smoke config, the
    train step traced at one device makes no tensor ending in (S, T), and
    its live intermediates peak below those of the plain attention it
    traced before (whose scores it does make)."""
    Sq = 288            # scores of 2.7 MB a tensor: past the step's other
    cfg = get_config("llama3.2-1b", smoke=True)     # temps at 288 tokens
    assert Sq not in (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.head_dim,
                      cfg.n_heads * cfg.head_dim)

    def step_inputs():
        model = Transformer(cfg, device="meta", dtype=torch.float32,
                            trainable=True)
        batch = {k: torch.empty((B, Sq), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        return model, adamw_init(dict(model.named_parameters())), batch

    step = make_train_step(cfg, AdamWConfig())
    shapes, mem = _shapes_of(step, *step_inputs())
    assert not [s for s in shapes if s[-2:] == (Sq, Sq)]

    def plain(q, k, v, causal=True, window=None, cap=None):
        return attention_ref(q, k, v, causal=causal, window=window, cap=cap)

    with mock.patch.object(attention_mod, "flash_attention_op", plain):
        shapes_p, mem_p = _shapes_of(step, *step_inputs())
    assert [s for s in shapes_p if s[-2:] == (Sq, Sq)]
    assert mem.temp_bytes < mem_p.temp_bytes
    assert mem.arg_bytes == mem_p.arg_bytes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_stand_ins_allocate_what_k5_allocates(dtype):
    """K5 allocates ``out`` (q's shape and dtype) and, for training, the
    rows' f32 log-sum-exp (B, H, S); its backward dq, dk, dv (q's, k's,
    v's) and the f32 D scratch (B, H, S): ``kernel.flash_attention``,
    ``kernel.flash_attention_bwd``.  The stand-ins give the same, and
    through ``flash_attention_op`` on meta a gradient flows back."""
    Bq, Sq, T, H, K, hd = 2, 96, 80, 8, 2, 64
    q = torch.empty((Bq, Sq, H, hd), dtype=dtype, device="meta")
    k, v = (torch.empty((Bq, T, K, hd), dtype=dtype, device="meta")
            for _ in range(2))
    out, lse = torch.ops.repro_torch.k5_fwd(q, k, v, False, None, None)
    assert (out.shape, out.dtype) == (q.shape, dtype)
    assert (lse.shape, lse.dtype) == ((Bq, H, Sq), torch.float32)
    assert torch.ops.repro_torch.k5(q, k, v, True, 16, 50.0).shape == q.shape
    grads = torch.ops.repro_torch.k5_bwd(q, k, v, out, lse, True, 16, None)
    assert [(g.shape, g.dtype) for g in grads] == [
        (q.shape, dtype), (k.shape, dtype), (v.shape, dtype),
        ((Bq, H, Sq), torch.float32)]
    qg = q.requires_grad_()
    y = flash_attention_op(qg, k, v, causal=True)
    (dq,) = torch.autograd.grad(y.float().sum(), qg)
    assert dq.shape == q.shape and dq.is_meta


def test_a_sharded_k5_call_counts_its_share_of_the_walk():
    """K5's stand-in on a (1, 4) meta mesh counts, per device, a quarter
    of the global call's product flops whether q is split over its heads
    or over its query rows (the ``seq_mp`` fallback): for the query rows
    that is the mean over the ranks, above the causal walk of rank 0's
    rows from position 0."""
    devs = np.empty((1, 4), dtype=object)
    devs[:] = torch.device("meta")
    Bq, Sq, H, hd = 2, 512, 4, 16
    t = torch.empty((Bq, Sq, H, hd), device="meta")
    whole = k5_product_flops("fwd", t, t, True, None)
    assert k5_product_flops("fwd", t[:, :Sq // 4], t, True, None) < whole / 4

    def attend(q, k, v):
        return flash_attention_op(q, k, v, causal=True)

    with dryrun.device_mesh_of(FleetMesh(devs, ("data", "model"))) as dm, \
            dryrun._replicated(dm):
        kv = dryrun.place(t, dm, None)
        for spec in [(None, "model", None, None), (None, None, "model", None)]:
            cost, _, _ = trace_program(attend, dryrun.place(t, dm, spec),
                                       kv, kv)
            assert cost.attention_flops == whole / 4, spec


def test_host_ops_pass_lets_only_integer_host_tensors_through():
    """Inside ``host_ops_pass`` a program's op on an integer host tensor
    (DTensor's bookkeeping) runs uncounted; one on a float host tensor
    still raises."""
    x = torch.empty(4, device="meta")

    def coordinate(x):
        return x * (torch.ones(512, dtype=torch.int64) + 1).sum().item()

    def host_float(x):
        return x * (torch.ones(2) * 2).sum().item()

    with host_ops_pass():
        trace_program(coordinate, x)
        with pytest.raises(ValueError, match="meta tensors only"):
            trace_program(host_float, x)


# ---- the dry run over a (2, 4) mesh against the reference's record ----------
RECORD = (Path(__file__).resolve().parent / "torch_records"
          / "dryrun_reference_2x4.json")


@pytest.fixture(scope="module")
def mesh_cells():
    """The smoke llama3.2-1b × train_4k at one device and on a (2, 4) meta
    mesh under both policies, one micro-batch each, as the record's."""
    rec = json.loads(RECORD.read_text())
    cfg = get_config(rec["arch"], smoke=True)
    devs = np.empty(tuple(rec["mesh"]), dtype=object)
    devs[:] = torch.device("meta")
    mesh = FleetMesh(devs, tuple(rec["axes"]))
    one = dryrun.run_cell(rec["arch"], rec["shape"], make_host_mesh(CPU),
                          verbose=False, cfg=cfg, policy="zero3",
                          microbatches=1)
    cells = {p: dryrun.run_cell(rec["arch"], rec["shape"], mesh,
                                verbose=False, cfg=cfg, policy=p,
                                microbatches=1) for p in rec["cells"]}
    return rec, cfg, one, cells


def k5_per_device(cfg, batch, heads, seq):
    """K5's rule on one device's shard: the forward twice a layer (remat
    runs it again) and the backward once, at f32 (the smoke config)."""
    q = torch.empty((batch, seq, heads, cfg.head_dim), device="meta")
    k = torch.empty((batch, seq, cfg.n_kv_heads, cfg.head_dim),
                    device="meta")
    return cfg.n_layers * (2 * k5_product_flops("fwd", q, k, True, None)
                           + k5_product_flops("bwd", q, k, True, None))




@pytest.mark.parametrize("policy", ["zero3", "dp_tp"])
def test_the_mesh_cells_count_per_device_as_the_reference(mesh_cells,
                                                          policy):
    rec, cfg, one, cells = mesh_cells
    ref, got = rec["cells"][policy], cells[policy]
    assert got["ok"] and got["n_devices"] == ref["n_devices"] == 8
    # each side's attention by its own rule: the reference's classified
    # dots are its blocks' count, the port's its stand-ins' on a shard
    # (the batch over 8 under zero3; over "data" and the heads over
    # "model" under dp_tp)
    assert ref["attention_dot_flops_per_dev"] == \
        ref["attention_block_flops_per_dev"]
    shard = ((rec["cells"][policy]["n_devices"], 1) if policy == "zero3"
             else (rec["mesh"][0], rec["mesh"][1]))
    SH = SHAPES[rec["shape"]]
    assert got["attention_flops_per_dev"] == k5_per_device(
        cfg, SH.global_batch // shard[0], cfg.n_heads // shard[1],
        SH.seq_len)
    port = got["product_flops_per_dev"] - got["attention_flops_per_dev"]
    jax_ = ref["dot_flops_per_dev"] - ref["attention_dot_flops_per_dev"]
    assert abs(port / jax_ - 1.0) < 0.10, port / jax_
    # the inputs on a device: the reference's bytes exactly (its batch
    # and the leaves too small to shard are whole on every device)
    assert got["arg_bytes_per_dev"] == ref["arg_bytes_per_dev"]
    if policy == "zero3":
        # the mesh divides the work: eight devices count the step's flops
        assert abs(got["flops_per_dev"] * 8 / one["flops_per_dev"] - 1) \
            < 0.02
        assert 0.5 < got["collective_bytes_per_dev"] \
            / ref["collective_bytes_per_dev"] < 2.0
        assert got["collective_counts"]["all-gather"] > 0
        assert got["collective_counts"]["reduce-scatter"] > 0


def test_the_example_cells_trace_on_the_production_meshes():
    """deepseek-7b and llama3.2-1b, the example's cells, on (16, 16) meta
    under zero3 (smoke configs, ``train_small``): per-device counts with
    the parameter gathers and gradient reductions of FSDP."""
    with smoke_cells():
        cells = dryrun.run_cells(
            [(a, SMALL.name) for a in ("deepseek-7b", "llama3.2-1b")],
            [("16x16", lambda: make_production_mesh(device="meta"))],
            policy="zero3")
    for c in cells:
        assert c["ok"], c
        assert c["n_devices"] == 256 and c["mesh"] == "16x16"
        assert c["flops_per_dev"] > 0 and c["temp_bytes_per_dev"] > 0
        assert c["collective_bytes_by_op"]["all-gather"] > 0
        assert c["collective_bytes_by_op"]["reduce-scatter"] > 0
