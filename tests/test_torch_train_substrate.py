"""The port's training substrate on the CPU: checkpoints, the hooks,
``RetryableStep``, the loop and the launcher (as
``tests/train/test_substrate.py`` tests the reference's), on the llama
smoke config (float32) with random weights from a seeded generator."""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.configs as PC
from repro_torch.data import SyntheticTokens, host_batch_iterator
from repro_torch.distributed.sharding import (POLICIES, active_mesh,
                                              logical_to_spec)
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, CheckpointHook,
                               HeartbeatMonitor, RetryableStep, TrainState,
                               checkpoint as ckpt, make_train_step,
                               train_loop)
from repro_torch.train.loop import cast_copy, loss_and_grads

CFG = PC.get_config("llama3.2-1b", smoke=True)
OPT = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)


def fresh_state(seed=0):
    model = init_params(CFG, torch.Generator().manual_seed(seed),
                        device="cpu", dtype=torch.float32, trainable=True)
    return TrainState.create(model)


def data(start=0):
    src = SyntheticTokens(vocab=CFG.vocab, seq_len=32, global_batch=4)
    return host_batch_iterator(src, CFG, start_step=start)


def params_of(state):
    return {k: v.detach().clone()
            for k, v in state.params.named_parameters()}


def test_checkpoint_round_trip_restores_every_leaf(tmp_path):
    st = fresh_state()
    train_loop(CFG, OPT, st, data(), 2, train_step=make_train_step(CFG, OPT),
               log_every=0)
    tree = {"params": st.params, "opt": st.opt_state, "extra": [np.arange(3),
                                                               2.5]}
    path = ckpt.save(str(tmp_path), 2, tree, extra={"note": "x"})
    assert path.endswith("step_00000002")
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert manifest["n_leaves"] == len(list(st.params.parameters())) * 3 + 3
    saved = params_of(st)
    mu = {k: v.clone() for k, v in st.opt_state.mu.items()}
    other = fresh_state(seed=1)
    out, man = ckpt.restore(path, {"params": other.params,
                                   "opt": other.opt_state,
                                   "extra": [np.zeros(3, np.int64), 0.0]})
    assert out["params"] is other.params and man["extra"] == {"note": "x"}
    for k, v in other.params.named_parameters():
        assert torch.equal(v, saved[k])
    for k in mu:
        assert torch.equal(out["opt"].mu[k], mu[k])
    assert int(out["opt"].step) == 2 and out["opt"].step.dtype == torch.int32
    np.testing.assert_array_equal(out["extra"][0], np.arange(3))
    assert out["extra"][1] == 2.5


def test_bf16_leaves_come_back_in_bf16(tmp_path):
    x = torch.randn(5).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 1, {"x": x})
    out, _ = ckpt.restore(ckpt.latest(str(tmp_path)),
                          {"x": torch.zeros(5, dtype=torch.bfloat16)})
    assert out["x"].dtype == torch.bfloat16 and torch.equal(out["x"], x)


def test_restore_rejects_wrong_template(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(ckpt.latest(str(tmp_path)),
                     {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(ckpt.latest(str(tmp_path)), {"a": torch.zeros(4)})


def test_latest_skips_unfinished_writes(tmp_path):
    assert ckpt.latest(str(tmp_path / "none")) is None
    ckpt.save(str(tmp_path), 3, {"a": torch.ones(2)})
    ckpt.save(str(tmp_path), 7, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000011")        # no manifest
    assert ckpt.latest(str(tmp_path)).endswith("step_00000007")


def test_async_save_writes_after_the_values_are_taken(tmp_path):
    x = torch.arange(6.0)
    ckpt.save_async(str(tmp_path), 4, {"x": x})
    x.add_(100.0)                      # changed after the host copy
    ckpt.wait_pending()
    out, man = ckpt.restore(ckpt.latest(str(tmp_path)),
                            {"x": torch.zeros(6)})
    assert man["step"] == 4
    assert torch.equal(out["x"], torch.arange(6.0))


def test_checkpoint_hook_keeps_the_newest(tmp_path):
    st = fresh_state()
    hook = CheckpointHook(str(tmp_path), every=2, keep=2, asynchronous=False)
    for step_n in range(1, 7):
        hook(step_n, {"loss": 1.0}, st)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000006"]
    _, manifest = ckpt.restore(ckpt.latest(str(tmp_path)),
                               {"params": st.params, "opt": st.opt_state})
    assert manifest["step"] == 6 and manifest["extra"]["loss"] == 1.0


def test_resume_replays_the_uninterrupted_run(tmp_path):
    """Save at step 2, go on to 4; restore into a fresh state and replay
    steps 3–4 from the stateless pipeline: the same losses and weights."""
    step = make_train_step(CFG, OPT)
    st = fresh_state()
    hook = CheckpointHook(str(tmp_path), every=2, keep=5, asynchronous=False)
    hist = train_loop(CFG, OPT, st, data(), 4, train_step=step,
                      hooks=[hook], log_every=0)
    other = fresh_state(seed=3)
    tree, man = ckpt.restore(os.path.join(tmp_path, "step_00000002"),
                             {"params": other.params,
                              "opt": other.opt_state})
    other.params, other.opt_state = tree["params"], tree["opt"]
    other.step = man["step"]
    again = train_loop(CFG, OPT, other, data(other.step), 2,
                       train_step=step, log_every=0)
    assert [h["loss"] for h in again] == [h["loss"] for h in hist[2:]]
    for k, v in other.params.named_parameters():
        assert torch.equal(v, dict(st.params.named_parameters())[k])


def test_retryable_step_restores_and_replays(tmp_path):
    step = make_train_step(CFG, OPT)
    st = fresh_state()
    it = data()
    train_loop(CFG, OPT, st, it, 2, train_step=step, log_every=0)
    ckpt.save(str(tmp_path), st.step, {"params": st.params,
                                       "opt": st.opt_state})
    saved = params_of(st)
    calls = {"n": 0}

    def flaky(model, opt, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return step(model, opt, batch)

    rs = RetryableStep(flaky, str(tmp_path), max_retries=1)
    out, nxt = rs(st, next(it))        # step 3 succeeds
    assert out is not None and nxt == 3
    st.params, st.opt_state, _ = out
    st.step = nxt
    out, nxt = rs(st, next(it))        # step 4 fails: back to step 2
    assert out is None and nxt == 2 and st.step == 2
    for k, v in st.params.named_parameters():
        assert torch.equal(v, saved[k])
    assert int(st.opt_state.step) == 2
    rs.failures = 1
    calls["n"] = 1
    with pytest.raises(RuntimeError, match="illegal"):
        rs(st, next(data(2)))           # past max_retries: re-raised


def test_retryable_step_without_a_checkpoint_raises(tmp_path):
    def broken(*a):
        raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="no checkpoint"):
        RetryableStep(broken, str(tmp_path / "none"))(fresh_state(),
                                                       next(data()))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b"])
def test_bf16_steps_run_on_a_cast_copy_under_every_remat(arch):
    """In bf16 the forward runs on a copy of the f32 masters cast to bf16
    (norm scales and the MoE router included); remat recomputes layers
    from that copy's parameters, so "full" and "dots" give "none"'s loss
    and gradients, in f32 and finite, and the masters stay f32."""
    cfg = PC.get_config(arch, smoke=True).replace(dtype="bfloat16")
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu", dtype=torch.float32, trainable=True)
    copy = cast_copy(model)
    assert {p.dtype for p in copy.parameters()} == {torch.bfloat16}
    batch = next(data())
    runs = {}
    for remat in ("none", "full", "dots"):
        model.cfg = cfg.replace(remat=remat)
        runs[remat] = loss_and_grads(model, batch)
    total, _, grads = runs["none"]
    assert torch.isfinite(total)
    for remat in ("full", "dots"):
        t, _, g = runs[remat]
        assert torch.equal(t, total)
        for k, v in grads.items():
            assert v.dtype == torch.float32 and torch.isfinite(v).all()
            assert torch.equal(g[k], v), (remat, k)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_heartbeat_straggler_detection():
    import time
    mon = HeartbeatMonitor(n_hosts=3, deadline_factor=2.0)
    assert mon.host_id == 0
    for _ in range(6):
        for h in (0, 1):
            mon.beat(h)
        time.sleep(0.01)
    assert 2 in mon.stragglers()
    assert 0 not in mon.stragglers()


def test_loop_trains_and_launcher_runs_on_the_cpu(tmp_path, capsys):
    hist = launch_train.main(["--device", "cpu", "--steps", "12",
                              "--seq", "32", "--global-batch", "4",
                              "--microbatches", "2", "--ckpt-every", "6",
                              "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 12
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not any(h["skipped"] for h in hist)
    assert ckpt.latest(str(tmp_path)).endswith("step_00000012")
    hist2 = launch_train.main(["--device", "cpu", "--steps", "14",
                               "--seq", "32", "--global-batch", "4",
                               "--microbatches", "2", "--resume",
                               "--ckpt-dir", str(tmp_path)])
    assert len(hist2) == 2
    assert "resumed from step 12" in capsys.readouterr().out


@pytest.mark.parametrize("policy", ["zero3", "no_such_policy"])
def test_launcher_policy_moves_no_number(policy, tmp_path, monkeypatch):
    """Under ``--policy zero3`` the launcher's losses are ``dp_tp``'s bit
    for bit; inside, the 1×1 host mesh and the policy's rules are
    installed, and both are gone when it returns.  A policy the JAX
    launcher lacks is refused."""
    args = ["--device", "cpu", "--steps", "3", "--seq", "32",
            "--global-batch", "4", "--microbatches", "2"]
    if policy not in POLICIES:
        with pytest.raises(SystemExit):
            launch_train.main(args + ["--policy", policy])
        return
    seen = []
    train = launch_train._train

    def spy(*a):
        mesh = active_mesh()
        seen.append((mesh.axis_names, mesh.devices.shape,
                     logical_to_spec("batch", "fsdp", "ff",
                                     shape=(4, 64, 128))))
        return train(*a)
    monkeypatch.setattr(launch_train, "_train", spy)
    runs = [launch_train.main(args + ["--policy", p, "--ckpt-dir",
                                      str(tmp_path / p)])
            for p in ("dp_tp", policy)]
    losses = [[h["loss"] for h in hist] for hist in runs]
    assert losses[0] == losses[1] and len(losses[0]) == 3
    assert seen == [(("data", "model"), (1, 1), ("data", None, "model")),
                    (("data", "model"), (1, 1),
                     (("data", "model"), None, None))]
    assert active_mesh() is None


def test_launcher_defaults_to_the_card(monkeypatch):
    """Without ``--device`` the launcher asks for CUDA, and without a GPU
    that raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        launch_train.main(["--steps", "1"])
