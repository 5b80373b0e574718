"""Port vs JAX: the serving path of the model stack.

JAX's ``init_params(PRNGKey(0))`` goes through ``params_from_arrays``;
then JAX's ``prefill`` + ``decode_step`` and the port's run on the same
numpy tokens: B = 2, S = 33 (longer than the smoke window of 16 and
ragged against ``scan_chunk`` 32 and the MoE's group of 64), ``max_len``
64, at the reference's own prefill/decode tolerance
(``tests/models/test_serving.py``: atol 2e-4, rtol 1e-3).  The VLM also
gets patches (B, n_patches, patch_dim) and the encoder–decoder frames
(B, 40, patch_dim), the same numpy arrays on both sides.  MoE runs
through dispatch, the configs' default, and once through the dense
oracle as the reference's own test runs it.  On the CPU the port's
kernels run their plain versions.
"""
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.serve import ServeEngine as JServeEngine
import repro_torch.configs as PC
import repro_torch.models as PM
from repro_torch.convert import params_from_arrays
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
# every config the repo ships; "qwen2-moe-a2.7b:dense" serves the MoE
# through its dense oracle
ARCHS = ["recurrentgemma-2b", "llama3.2-1b", "gemma2-27b", "qwen1.5-4b",
         "deepseek-7b", "falcon-mamba-7b", "qwen2-moe-a2.7b", "dbrx-132b",
         "qwen2-moe-a2.7b:dense", "internvl2-1b", "seamless-m4t-medium"]
B, S, MAX_LEN, STEPS = 2, 33, 64, 3
S_SRC = 40
CACHE = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(arch):
    """(JAX cfg, port cfg) of ``arch`` (``name:dense`` for the MoE's dense
    path)."""
    name, _, impl = arch.partition(":")
    over = {"moe_impl": impl} if impl else {}
    return (JC.get_config(name, smoke=True).replace(**over),
            PC.get_config(name, smoke=True).replace(**over))


def extra_inputs(cfg, rng):
    """The VLM's patches and the encoder–decoder's frames, numpy f32."""
    out = {}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, S_SRC, cfg.patch_dim)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX cfg, JAX params, the port's model with the same numbers,
    tokens (B, S + STEPS), patches/frames where the config takes them)."""
    jcfg, pcfg = configs(request.param)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_arrays(pcfg, tree, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    return jcfg, params, model, toks, extra_inputs(jcfg, rng)


def prefix_len(cfg):
    return cfg.n_patches if cfg.family == "vlm" else 0


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(pair, cache):
    jcfg, params, model, toks, extra = pair
    jdt, tdt = CACHE[cache]
    batch = {"tokens": toks[:, :S], **extra}
    lj, sj = JM.prefill(params, jax_batch(batch), jcfg, max_len=MAX_LEN,
                        cache_dtype=jdt)
    lp, sp = PM.prefill(model, batch, max_len=MAX_LEN, cache_dtype=tdt)
    assert lp.shape == (B, jcfg.vocab) and lp.dtype == torch.float32
    close(lp, lj)
    for t in range(S, S + STEPS):           # teacher-forced decode
        lj, sj = JM.decode_step(params, jnp.asarray(toks[:, t:t + 1]), sj,
                                jcfg)
        lp, sp = PM.decode_step(model, toks[:, t:t + 1], sp)
        close(lp, lj)
    assert sp["pos"] == int(sj["pos"]) == prefix_len(jcfg) + S + STEPS


def test_decode_state_matches_jax(pair):
    """The prefill's decode state, unstacked from JAX's per-cycle groups
    into the port's layer order: KV rings, the RG-LRU's and Mamba's
    (h, conv), and the encoder–decoder's cross (k, v) a layer."""
    jcfg, params, model, toks, extra = pair
    batch = {"tokens": toks[:, :S], **extra}
    _, sj = JM.prefill(params, jax_batch(batch), jcfg, max_len=MAX_LEN,
                       cache_dtype=jnp.float32)
    _, sp = PM.prefill(model, batch, max_len=MAX_LEN,
                       cache_dtype=torch.float32)
    assert ("cross" in sp) == ("cross" in sj)
    for i, kv in enumerate(sp.get("cross", [])):
        for got, ref in zip(kv, sj["cross"]):
            assert got.dtype == torch.float32 and got.shape[1] == S_SRC
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[i]),
                                       atol=1e-5, rtol=1e-5)
    cyc = len(jcfg.cycle)
    G = jcfg.n_layers // cyc
    for i, cache in enumerate(sp["layers"]):
        ref = (jax.tree_util.tree_map(lambda x: x[i // cyc],
                                      sj["blocks"][i % cyc])
               if i < cyc * G else sj["tail"][i - cyc * G])
        assert sorted(cache) == sorted(ref)
        for key, val in cache.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(ref[key]),
                                       atol=1e-5, rtol=1e-5)


def test_full_forward_agrees_with_prefill_and_decode(pair):
    """The port's own consistency: logits of the cache-free full-sequence
    forward at positions St−1 and St equal prefill's and one decode
    step's.  MoE takes its dense path here, as the reference's own test
    does: dispatch's capacity drops depend on how the tokens fall into
    groups, which differs between S + 1 tokens and S."""
    jcfg, _, model, toks, extra = pair
    if jcfg.moe:
        model = copy.copy(model)
        model.cfg = model.cfg.replace(moe_impl="dense")
    full = model(toks[:, :S + 1], **extra)
    off = prefix_len(jcfg)
    assert full.shape == (B, off + S + 1, jcfg.vocab)
    lp, st = PM.prefill(model, {"tokens": toks[:, :S], **extra},
                        max_len=MAX_LEN, cache_dtype=torch.float32)
    ld, _ = PM.decode_step(model, toks[:, S:S + 1], st)
    torch.testing.assert_close(lp, full[:, off + S - 1], atol=2e-4,
                               rtol=1e-3)
    torch.testing.assert_close(ld, full[:, off + S], atol=2e-4, rtol=1e-3)


def test_greedy_generate_matches_jax_engine(pair):
    jcfg, params, model, toks, extra = pair
    batch = {"tokens": toks[:, :S], **extra}
    ref = JServeEngine(cfg=jcfg, params=params, max_len=MAX_LEN).generate(
        batch, 6)
    out = ServeEngine(model=model, max_len=MAX_LEN).generate(batch, 6)
    assert out.dtype == np.int32 and out.shape == (B, 6)
    np.testing.assert_array_equal(out, ref)


# A global attention layer's cache holds max_len positions; a write past
# it is refused before anything is written (the JAX package drops it).
ROOM = 24


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_cache_writes_past_max_len_are_refused(arch, monkeypatch):
    jcfg = JC.get_config(arch, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_arrays(PC.get_config(arch, smoke=True),
                               jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (B, ROOM + 1)).astype(np.int32)
    with monkeypatch.context() as m:     # refused before any layer runs
        m.setattr(PM.transformer, "prefill_attention",
                  lambda *a, **k: pytest.fail("prefill wrote a cache"))
        with pytest.raises(ValueError, match=f"{ROOM + 1} token.*pos 0 "
                                             f".*max_len {ROOM}"):
            PM.prefill(model, {"tokens": toks}, max_len=ROOM)
    # the last position that fits still matches JAX
    lj, sj = JM.prefill(params, {"tokens": jnp.asarray(toks[:, :ROOM - 1])},
                        jcfg, max_len=ROOM, cache_dtype=jnp.float32)
    lp, sp = PM.prefill(model, {"tokens": toks[:, :ROOM - 1]},
                        max_len=ROOM, cache_dtype=torch.float32)
    close(lp, lj)
    last = toks[:, ROOM - 1:ROOM]
    lj, sj = JM.decode_step(params, jnp.asarray(last), sj, jcfg)
    lp, sp = PM.decode_step(model, last, sp)
    close(lp, lj)
    assert sp["pos"] == ROOM
    kept = [{k: v.clone() for k, v in c.items()} for c in sp["layers"]]
    with pytest.raises(ValueError, match=f"pos {ROOM} .*max_len {ROOM}"):
        PM.decode_step(model, toks[:, ROOM:], sp)
    assert sp["pos"] == ROOM
    for cache, before in zip(sp["layers"], kept):
        for key, val in cache.items():
            assert torch.equal(val, before[key])


def test_local_rings_decode_past_max_len():
    """recurrentgemma's attention layers are all local rings: a prompt and
    decode steps past max_len (= the window) are not refused, and agree
    with the cache-free forward."""
    model = PM.init_params(PC.get_config("recurrentgemma-2b", smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    assert "attn" not in model.cfg.layer_kinds()
    window = model.cfg.window
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab, (B, window + 8)).astype(np.int32)
    n = window + 4
    full = model(toks)
    lp, st = PM.prefill(model, {"tokens": toks[:, :n]}, max_len=window,
                        cache_dtype=torch.float32)
    torch.testing.assert_close(lp, full[:, n - 1], atol=2e-4, rtol=1e-3)
    for t in range(n, toks.shape[1]):
        lp, st = PM.decode_step(model, toks[:, t:t + 1], st)
        torch.testing.assert_close(lp, full[:, t], atol=2e-4, rtol=1e-3)
    assert st["pos"] == toks.shape[1]


@pytest.mark.parametrize("S", [1, 2])
def test_rglru_decode_after_a_short_prompt(S):
    """A prompt shorter than the RG-LRU conv window (S < conv − 1) keeps
    a window left-padded with zeros, the rows the cache-free forward's
    causal conv sees before the first token: prefill and the decode
    steps after it agree with that forward."""
    model = PM.init_params(PC.get_config("recurrentgemma-2b", smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    assert S < model.cfg.ssm_conv - 1
    toks = np.random.default_rng(11).integers(
        0, model.cfg.vocab, (B, S + 6)).astype(np.int32)
    full = model(toks)
    lp, st = PM.prefill(model, {"tokens": toks[:, :S]}, max_len=32,
                        cache_dtype=torch.float32)
    torch.testing.assert_close(lp, full[:, S - 1], atol=2e-4, rtol=1e-3)
    for t in range(S, toks.shape[1]):
        lp, st = PM.decode_step(model, toks[:, t:t + 1], st)
        torch.testing.assert_close(lp, full[:, t], atol=2e-4, rtol=1e-3)
    assert st["pos"] == toks.shape[1]


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_is_deterministic_for_a_seed(temperature):
    model = PM.init_params(PC.get_config("recurrentgemma-2b", smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": np.ones((2, 8), np.int32)}
    eng = ServeEngine(model=model, max_len=64, temperature=temperature)
    a = eng.generate(batch, 6)
    np.testing.assert_array_equal(a, eng.generate(batch, 6))
    assert a.shape == (2, 6) and np.all((a >= 0) & (a < model.cfg.vocab))
    if temperature:
        other = dataclasses.replace(eng, seed=1).generate(batch, 6)
        assert not np.array_equal(a, other)


def test_sampling_takes_fresh_draws():
    """Each sampled token comes from new generator state: with a flat
    distribution the draws of one call are not all equal."""
    model = PM.init_params(PC.get_config("llama3.2-1b", smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model=model, max_len=64, temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    flat = torch.zeros(4, 512)
    draws = torch.stack([eng._sample(flat, gen) for _ in range(8)])
    assert len(set(draws.flatten().tolist())) > 8


def test_vlm_without_patches_serves_text_only():
    """Without patches the VLM embeds the tokens alone, as the JAX
    package's prefill does: positions 0 … S−1, pos S."""
    jcfg, pcfg = configs("internvl2-1b")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_arrays(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    lj, sj = JM.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                        max_len=MAX_LEN, cache_dtype=jnp.float32)
    lp, sp = PM.prefill(model, {"tokens": toks[:, :S]}, max_len=MAX_LEN,
                        cache_dtype=torch.float32)
    close(lp, lj)
    assert sp["pos"] == int(sj["pos"]) == S
    torch.testing.assert_close(lp, model(toks[:, :S])[:, -1], atol=2e-4,
                               rtol=1e-3)


def test_vlm_cache_room_counts_the_patches():
    """The cache-room check counts n_patches + S: a prompt that fits
    max_len alone but not with its patches is refused."""
    _, pcfg = configs("internvl2-1b")
    model = PM.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(5)
    n = pcfg.n_patches
    batch = {"tokens": rng.integers(0, pcfg.vocab, (B, 20)),
             **extra_inputs(pcfg, rng)}
    with pytest.raises(ValueError, match=f"{n + 20} token.*max_len 24"):
        PM.prefill(model, batch, max_len=24)
    _, st = PM.prefill(model, batch, max_len=n + 20)
    assert st["pos"] == n + 20


def test_encoder_decoder_needs_frames():
    _, pcfg = configs("seamless-m4t-medium")
    model = PM.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="frames"):
        PM.prefill(model, {"tokens": np.ones((B, 4), np.int32)}, max_len=16)


def test_init_decode_state_carries_cross():
    """Zeroed cross K/V a decoder layer, (B, src_len, K, hd) in the cache
    dtype, as the JAX package's (stacked) template."""
    jcfg, pcfg = configs("seamless-m4t-medium")
    st = PM.init_decode_state(pcfg, B, 16, src_len=S_SRC, device="cpu")
    ref = JM.init_decode_state(jcfg, B, 16, src_len=S_SRC)
    assert len(st["cross"]) == pcfg.n_layers == ref["cross"][0].shape[0]
    for kv in st["cross"]:
        for t in kv:
            assert t.shape == ref["cross"][0].shape[1:]
            assert t.dtype == torch.bfloat16 and not t.any()


@pytest.mark.parametrize("arch", JC.list_archs())
def test_configs_match_jax(arch):
    for smoke in (False, True):
        j, p = JC.get_config(arch, smoke), PC.get_config(arch, smoke)
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(p) == jd
        assert p.param_count() == j.param_count()
        assert p.compute_dtype == {"bfloat16": torch.bfloat16,
                                   "float32": torch.float32}[j.dtype]


def test_full_recurrentgemma_shapes():
    """The full-width model built on the meta device: 26 layers, 18 RG-LRU
    and 8 local MQA, and the matrices ``param_count`` counts."""
    cfg = PC.get_config("recurrentgemma-2b")
    model = Transformer(cfg, device="meta")
    kinds = [blk.kind for blk in model.layers]
    assert kinds.count("rglru") == 18 and kinds.count("local") == 8
    assert model.embed.dtype == torch.bfloat16
    local = model.layers[2].mixer
    assert local.wk.shape == (2560, 256) and local.wq.shape == (2560, 2560)
    counted = sum(p.numel() for n, p in model.named_parameters()
                  if p.ndim == 2 and "conv_w" not in n)
    assert counted == cfg.param_count() == 2_894_069_760


def matrices(model, skip=()):
    return sum(p.numel() for n, p in model.named_parameters()
               if p.ndim >= 2 and not any(k in n for k in skip))


def test_full_qwen2_moe_shapes():
    """Full qwen2-moe-a2.7b on the meta device: 24 MoE layers of 60
    routed experts (f32 router) and 4 shared ones, and the matrices
    ``param_count`` counts."""
    cfg = PC.get_config("qwen2-moe-a2.7b")
    model = Transformer(cfg, device="meta")
    moe = model.layers[0].mlp
    assert moe.router.shape == (2048, 60) and moe.router.dtype == torch.float32
    assert moe.expert_gate.shape == (60, 2048, 1408)
    assert moe.expert_down.shape == (60, 1408, 2048)
    assert moe.expert_up.dtype == torch.bfloat16
    assert moe.shared.w_gate.shape == (2048, 1408 * 4)
    assert model.layers[0].mixer.bq.shape == (2048,)
    assert matrices(model) == cfg.param_count() == 14_315_487_232


def test_full_seamless_shapes():
    """Full seamless-m4t-medium on the meta device: 12 bidirectional
    encoder layers, 12 decoder layers with cross-attention, the frame
    projection, and the matrices ``param_count`` counts (all but the
    frame projection, which it leaves out)."""
    cfg = PC.get_config("seamless-m4t-medium")
    model = Transformer(cfg, device="meta")
    assert [b.kind for b in model.enc_layers] == ["bidir"] * 12
    assert [b.kind for b in model.layers] == ["attn"] * 12
    assert all(b.cross is not None and b.norm_x is not None
               for b in model.layers)
    assert model.layers[0].cross.wk.shape == (1024, 1024)
    assert model.frontend_proj.shape == (1024, 1024)
    assert matrices(model, skip=("frontend_proj",)) == cfg.param_count()


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.get_config("recurrentgemma-2b", smoke=True)
    with pytest.raises(RuntimeError, match="no GPU"):
        PM.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no GPU"):
        PM.init_decode_state(cfg, 2, 64)
    with pytest.raises(RuntimeError, match="no GPU"):
        params_from_arrays(cfg, {})


def test_launcher_serves_on_the_cpu():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.serve import main; "
            "main(['--arch', 'recurrentgemma-2b', '--batch', '2', "
            "'--prompt-len', '20', '--gen', '4', '--requests', '2', "
            "'--device', 'cpu'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("request wave 0: (2, 4)")
    assert lines[-1].startswith("served 16 tokens") and "cpu" in lines[-1]


def test_launcher_serves_mamba_on_the_cpu():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.serve import main; "
            "main(['--arch', 'falcon-mamba-7b', '--batch', '2', "
            "'--prompt-len', '40', '--gen', '3', '--requests', '2', "
            "'--device', 'cpu'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("request wave 0: (2, 3)")
    assert lines[-1].startswith("served 12 tokens") and "cpu" in lines[-1]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b",
                                  "internvl2-1b", "seamless-m4t-medium"])
def test_launcher_serves_the_other_families_on_the_cpu(arch):
    """MoE (through the dense path on the smoke config, as the JAX
    launcher serves it), the VLM with its patches and the
    encoder–decoder with its frames."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.serve import main; "
            f"main(['--arch', '{arch}', '--batch', '2', "
            "'--prompt-len', '20', '--gen', '3', '--requests', '2', "
            "'--device', 'cpu'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("request wave 0: (2, 3)")
    assert lines[-1].startswith("served 12 tokens") and "cpu" in lines[-1]
