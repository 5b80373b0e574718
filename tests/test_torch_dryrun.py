"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's, on the smoke configs of llama3.2-1b and qwen2-moe-a2.7b (the
MoE's expert occupancy is counted on meta).

The JAX side is built here from ``make_train_step`` and read through
``analyze_hlo``'s ``top_contributors`` on the compiled HLO:
``repro.launch.dryrun`` is not imported, since it asks XLA for 512
devices when it is imported.

Tolerance: the port's train-step product flops (``top_contributors``
of the meta trace, "flops") are held to the JAX HLO's dot flops within
5%; they read 0.967 (llama) and 1.012 (qwen2-moe) at 2 × 64 tokens.
What accounts for the rest: the JAX blocked attention
(``flash_attention_xla``) checkpoints its own blocks, so its backward
recomputes two attention products a layer more than the port's plain
attention; the port's MoE router runs one more small product in its
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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.launch.hlo_analysis import top_contributors, trace_program
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Transformer, init_params
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
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              ce_chunk=CE_CHUNK)
    params = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    cfg))
    opt = jax.eval_shape(lambda: jax_adamw_init(params))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    txt = jax.jit(jax_train_step(cfg, JaxAdamW())).lower(
        params, opt, batch).compile().as_text()
    return sum(r[0] for r in jax_top(txt, "flops", k=10 ** 7))


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
    assert {r[2] for r in rows} <= {"mm", "bmm", "addmm", "baddbmm"}
    port = sum(r[0] for r in rows)
    ref = jax_dot_flops(arch)
    assert abs(port / ref - 1.0) < DOT_RTOL, (port, ref, port / ref)


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


def test_a_mesh_of_more_than_one_device_is_not_ok(tmp_path):
    devs = np.empty((2, 1), dtype=object)
    devs[:] = [[CPU], [CPU]]
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        dryrun.run_cell("llama3.2-1b", "train_4k",
                        FleetMesh(devs, ("data", "model")), verbose=False)
    out = dryrun.run_cells([("llama3.2-1b", "train_4k")],
                           [("2x1", lambda: FleetMesh(devs,
                                                      ("data", "model")))])
    assert out == [{"arch": "llama3.2-1b", "shape": "train_4k",
                    "mesh": "2x1", "ok": False, "error": out[0]["error"]}]
    assert "ROADMAP item 9" in out[0]["error"]
    # main's production mesh: no 256 cards here, recorded as not ok
    path = tmp_path / "out.json"
    rc = dryrun.main(["--multi-pod", "--arch", "llama3.2-1b", "--shape",
                      "train_4k", "--out", str(path)])
    cells = json.loads(path.read_text())
    assert rc == 1 and [c["ok"] for c in cells] == [False]
    assert cells[0]["mesh"] == "2x16x16"


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
