"""Port vs JAX: AdamW, the train step, gradient compression and data.

The same numpy inputs go to both packages (f32, CPU).
- ``cosine_schedule`` at warm-up, mid-way and the end, to 1e-7.
- ``adamw_update`` with ``skip`` false (parameters and moments to rtol
  1e-6, atol 1e-8) and true (bit for bit the old ones, step kept).
- One ``make_train_step`` step of the llama smoke config at
  ``microbatches`` 1 and 4 against the reference's own: loss to 1e-5,
  grad norm to 1e-4, parameters to atol 1e-4 (lr/10), rtol 1e-5, all but
  0.1% of them to atol 5e-6 (the reference's own test holds
  microbatching to atol 5e-4, rtol 5e-3:
  ``tests/train/test_substrate.py:39-40``), and 1 against 4 in the port.
- int8 codes and scales equal the reference's; error feedback over
  steps equal to rtol 1e-6.
- ``batch_at`` and ``host_batch_iterator`` (VLM patches, encoder–decoder
  frames) equal the reference's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JDATA
import repro.distributed.compression as JCMP
import repro.models as JM
import repro.train as JT
import repro_torch.configs as PC
import repro_torch.data as PDATA
import repro_torch.distributed.compression as PCMP
import repro_torch.train as PT
from repro_torch.convert import arrays_from_params, params_from_arrays


def flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_cosine_schedule_matches_jax():
    cfg = PT.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    jcfg = JT.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=200)
    for step in (0, 1, 10, 20, 21, 110, 199, 200, 250):
        got = float(PT.cosine_schedule(cfg, torch.tensor(step)))
        want = float(JT.cosine_schedule(jcfg, jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12,
                                   err_msg=str(step))
    assert float(PT.cosine_schedule(cfg, torch.tensor(20))) == pytest.approx(
        3e-3)
    assert float(PT.cosine_schedule(cfg, torch.tensor(200))) == pytest.approx(
        3e-4)


def _problem(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in
         shapes.items()}
    return p, g


@pytest.mark.parametrize("scale", [0.01, 10.0])   # under / over the clip
def test_adamw_update_matches_jax_over_steps(scale):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    p, g = _problem(scale=scale)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = JT.adamw_init(jp)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    ts = PT.adamw_init(tp)
    for i in range(4):
        gi = {k: v * (1 + i) for k, v in g.items()}
        jp, js, jm = JT.adamw_update(JT.AdamWConfig(**cfg), gi, js, jp,
                                     skip=jnp.asarray(False))
        tp, ts, tm = PT.adamw_update(
            PT.AdamWConfig(**cfg), {k: torch.tensor(v) for k, v in
                                    gi.items()}, ts, tp,
            skip=torch.tensor(False))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in p:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-8, err_msg=k)
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32


def test_adamw_skip_keeps_every_bit():
    p, g = _problem(1)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    ts = PT.adamw_init(tp)
    tp, ts, _ = PT.adamw_update(PT.AdamWConfig(), {k: torch.tensor(v) for
                                                   k, v in g.items()}, ts, tp)
    before = ({k: v.clone() for k, v in tp.items()},
              {k: v.clone() for k, v in ts.mu.items()},
              {k: v.clone() for k, v in ts.nu.items()}, int(ts.step))
    nan = {k: torch.full(v.shape, float("nan")) for k, v in tp.items()}
    tp, ts, m = PT.adamw_update(PT.AdamWConfig(), nan, ts, tp,
                                skip=torch.tensor(True))
    for now, then in zip((tp, ts.mu, ts.nu), before[:3]):
        for k in now:
            assert torch.equal(now[k], then[k])
    assert int(ts.step) == before[3] == 1
    assert torch.isnan(m["grad_norm"])


def test_moments_stay_f32_for_bf16_parameters():
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    ts = PT.adamw_init(tp)
    assert ts.mu["w"].dtype == ts.nu["w"].dtype == torch.float32
    tp, ts, _ = PT.adamw_update(PT.AdamWConfig(lr=0.1, warmup_steps=1),
                                {"w": torch.ones(4)}, ts, tp)
    assert tp["w"].dtype == torch.bfloat16 and float(tp["w"][0]) < 1.0


@pytest.fixture(scope="module")
def llama():
    jcfg = JC.get_config("llama3.2-1b", smoke=True)
    pcfg = PC.get_config("llama3.2-1b", smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    src = JDATA.SyntheticTokens(vocab=jcfg.vocab, seq_len=32,
                                global_batch=8)
    batch = next(JDATA.host_batch_iterator(src, jcfg))
    return jcfg, pcfg, params, batch


@pytest.mark.parametrize("micro", [1, 4])
def test_train_step_matches_jax(llama, micro):
    jcfg, pcfg, params, batch = llama
    opt = dict(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(JT.make_train_step(jcfg, JT.AdamWConfig(**opt),
                                       microbatches=micro))
    jst = JT.TrainState.create(params)
    jp, jo, jm = jstep(jst.params, jst.opt_state, batch)

    model = params_from_arrays(pcfg, jax.tree_util.tree_map(np.asarray,
                                                            params),
                               device="cpu", trainable=True)
    st = PT.TrainState.create(model)
    step = PT.make_train_step(pcfg, PT.AdamWConfig(**opt),
                              microbatches=micro)
    model, ost, m = step(st.params, st.opt_state, batch)
    assert set(m) == set(jm)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(m["skipped"]) == float(jm["skipped"]) == 0.0
    # Adam's first step moves a weight by ≈ lr·g/(|g| + eps): where |g| is
    # near eps the packages' gradient rounding moves that by up to ~lr, so
    # all weights are held to lr/10 and all but 0.1% to 5e-6
    for got, want in zip(flat(arrays_from_params(pcfg, model)), flat(jp)):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        assert np.mean(np.abs(got - want) > 5e-6 + 1e-5 * np.abs(want)) \
            < 1e-3
    for got, want in zip(flat(arrays_from_params(pcfg, model, ost.mu)),
                         flat(jo.mu)):
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-4)


def test_microbatches_equal_the_full_batch(llama):
    _, pcfg, params, batch = llama
    tree = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for micro in (1, 4):
        model = params_from_arrays(pcfg, tree, device="cpu", trainable=True)
        st = PT.TrainState.create(model)
        step = PT.make_train_step(pcfg, PT.AdamWConfig(lr=1e-3,
                                                       warmup_steps=1),
                                  microbatches=micro)
        model, _, m = step(st.params, st.opt_state, batch)
        out[micro] = (float(m["loss"]), [p.detach().clone() for p in
                                        model.parameters()])
    assert abs(out[1][0] - out[4][0]) < 1e-5
    for a, b in zip(out[1][1], out[4][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-6,
                                   rtol=1e-5)


def test_a_poisoned_step_changes_nothing(llama):
    _, pcfg, params, batch = llama
    model = params_from_arrays(pcfg, jax.tree_util.tree_map(np.asarray,
                                                            params),
                               device="cpu", trainable=True)
    st = PT.TrainState.create(model)
    step = PT.make_train_step(pcfg, PT.AdamWConfig(lr=1e-3))
    model, ost, _ = step(st.params, st.opt_state, batch)
    with torch.no_grad():
        model.embed[0, 0] = float("inf")
    before = [p.detach().clone() for p in model.parameters()]
    mu = {k: v.clone() for k, v in ost.mu.items()}
    model, ost2, m = step(model, ost, batch)
    assert float(m["skipped"]) == 1.0
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
    for k in mu:
        assert torch.equal(ost2.mu[k], mu[k])
    assert int(ost2.step) == 1


def test_compression_in_the_step(llama):
    _, pcfg, params, batch = llama
    tree = jax.tree_util.tree_map(np.asarray, params)
    seen = {}

    def comp(grads):
        seen["n"] = len(grads)
        return {k: PCMP.int8_compress(g) for k, g in grads.items()}

    model = params_from_arrays(pcfg, tree, device="cpu", trainable=True)
    st = PT.TrainState.create(model)
    step = PT.make_train_step(pcfg, PT.AdamWConfig(lr=1e-3),
                              compression=comp)
    _, _, m = step(st.params, st.opt_state, batch)
    assert seen["n"] == len(list(model.parameters()))
    assert float(m["skipped"]) == 0.0


@pytest.mark.parametrize("shape", [(1000,), (7, 300), (256,), (3,),
                                   (2, 128, 3)])
def test_int8_codes_and_scales_equal_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10.0)).astype(
        np.float32)
    x.reshape(-1)[::17] = 0.0
    jq, js, jn = JCMP._quantize(jnp.asarray(x))
    q, s, n = PCMP._quantize(torch.tensor(x))
    assert n == jn
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(PCMP.int8_compress(torch.tensor(x)).numpy(),
                                  np.asarray(JCMP.int8_compress(x)))


def test_error_feedback_over_steps_matches_jax():
    rng = np.random.default_rng(5)
    grads = [{"a": rng.standard_normal((40, 9)).astype(np.float32),
              "b": rng.standard_normal(300).astype(np.float32)}
             for _ in range(4)]
    jc, pc = JCMP.make_error_feedback_compressor(), \
        PCMP.make_error_feedback_compressor()
    jef = JCMP.init_ef_state(grads[0])
    pef = PCMP.init_ef_state({k: torch.tensor(v) for k, v in
                              grads[0].items()})
    for g in grads:
        jout, jef = jc(g, jef)
        pout, pef = pc({k: torch.tensor(v) for k, v in g.items()}, pef)
        for k in g:
            np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(pef[k].numpy(), np.asarray(jef[k]),
                                       rtol=1e-6, atol=1e-7)
    # the residual stays bounded by half a quantization step a block
    assert float(pef["b"].abs().max()) <= float(
        PCMP._quantize(pef["b"] + torch.tensor(grads[-1]["b"]))[1].max())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-1b",
                                  "seamless-m4t-medium"])
def test_batches_equal_jax_bit_for_bit(arch):
    jcfg = JC.get_config(arch, smoke=True)
    pcfg = PC.get_config(arch, smoke=True)
    kw = dict(vocab=jcfg.vocab, seq_len=24, global_batch=4, seed=3,
              doc_len=16)
    for hosts in ((1, 0), (2, 1)):
        j = JDATA.SyntheticTokens(**kw, n_hosts=hosts[0], host_id=hosts[1])
        p = PDATA.SyntheticTokens(**kw, n_hosts=hosts[0], host_id=hosts[1])
        for step in (0, 5):
            a, b = j.batch_at(step), p.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    ji = JDATA.host_batch_iterator(JDATA.SyntheticTokens(**kw), jcfg,
                                   start_step=2)
    pi = PDATA.host_batch_iterator(PDATA.SyntheticTokens(**kw), pcfg,
                                   start_step=2)
    for _ in range(2):
        a, b = next(ji), next(pi)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_token_file_batches_equal_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(5000, dtype=np.uint32).tofile(path)
    kw = dict(path=str(path), vocab=777, seq_len=16, global_batch=4)
    a = JDATA.pipeline.TokenFile(**kw).batch_at(3)
    b = PDATA.TokenFile(**kw).batch_at(3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    shape = type("Shape", (), {"global_batch": 8, "seq_len": 32})()
    for arch in ("llama3.2-1b", "internvl2-1b", "seamless-m4t-medium"):
        assert (PDATA.make_batch_specs(PC.get_config(arch, smoke=True),
                                       shape)
                == JDATA.make_batch_specs(JC.get_config(arch, smoke=True),
                                          shape))
