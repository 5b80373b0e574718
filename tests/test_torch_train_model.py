"""Port vs JAX: the training forward ``model_apply`` and its gradients.

JAX's ``init_params(PRNGKey(0))`` goes through ``params_from_arrays``
(trainable); the same numpy batch — tokens and labels (B, S), some
labels −1, the VLM's patches, the encoder–decoder's frames — goes to
``jax.value_and_grad(repro.models.model_apply)`` and to the port's
``model_apply`` + ``torch.autograd.grad``.  The port's gradients come
back in the JAX tree's layout through ``arrays_from_params`` and are held
leaf by leaf.  Smoke configs are float32 and the port runs its kernels'
plain versions on the CPU.  Tolerances: the serving tests' atol 2e-4 /
rtol 1e-3 on the loss and the aux terms, and on every gradient leaf
atol 2e-4 · (the leaf's largest |gradient|) with rtol 1e-3 (a leaf's
gradients span orders of magnitude; the loss is a mean over tokens).
Each arch's JAX reference is jitted once (module-scoped fixture).  The
remat modes none, full and dots give the same loss and gradients.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
import repro_torch.configs as PC
from repro_torch.convert import arrays_from_params, params_from_arrays
from repro_torch.models.transformer import model_apply

ARCHS = ["recurrentgemma-2b", "llama3.2-1b", "gemma2-27b", "qwen1.5-4b",
         "deepseek-7b", "falcon-mamba-7b", "qwen2-moe-a2.7b", "dbrx-132b",
         "internvl2-1b", "seamless-m4t-medium"]
B, S, S_SRC = 2, 33, 40
ATOL, RTOL = 2e-4, 1e-3


def make_batch(cfg, seed=2):
    """tokens, labels (every 7th −1) and the modality inputs, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, ::7] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, S_SRC, cfg.patch_dim)).astype(np.float32)
    return batch


def port_grads(model, batch):
    """(total, metrics, gradients keyed by parameter name) of the port."""
    params = dict(model.named_parameters())
    total, metrics = model_apply(model, batch)
    gs = torch.autograd.grad(total, list(params.values()))
    return total, metrics, dict(zip(params, gs))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jcfg = JC.get_config(request.param, smoke=True)
    pcfg = PC.get_config(request.param, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.model_apply(p, b, jcfg), has_aux=True))
    (jtotal, jmetrics), jgrads = fn(params, batch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_arrays(pcfg, tree, device="cpu", trainable=True)
    return (pcfg, model, batch, float(jtotal),
            {k: float(v) for k, v in jmetrics.items()},
            jax.tree_util.tree_map(np.asarray, jgrads))


def assert_grads_close(cfg, model, grads, ref):
    got = arrays_from_params(cfg, model, grads)
    flat_g, tg = jax.tree_util.tree_flatten_with_path(got)
    flat_r, tr = jax.tree_util.tree_flatten(ref)
    assert tg == tr
    for (path, g), r in zip(flat_g, flat_r):
        assert g.shape == r.shape, path
        np.testing.assert_allclose(
            g, r, rtol=RTOL, atol=ATOL * max(np.abs(r).max(), 1e-6),
            err_msg=jax.tree_util.keystr(path))


def test_loss_metrics_and_grads_match_jax(case):
    cfg, model, batch, jtotal, jmetrics, jgrads = case
    total, metrics, grads = port_grads(model, batch)
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(float(total), jtotal, rtol=RTOL, atol=ATOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert_grads_close(cfg, model, grads, jgrads)


def test_remat_modes_give_the_same_loss_and_grads(case):
    cfg, model, batch = case[:3]
    runs = {}
    for remat in ("none", "full", "dots"):
        model.cfg = cfg.replace(remat=remat)
        runs[remat] = port_grads(model, batch)
    model.cfg = cfg
    total, _, grads = runs["none"]
    for remat in ("full", "dots"):
        t, _, g = runs[remat]
        np.testing.assert_allclose(float(t), float(total), rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(g[k].numpy(), grads[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_return_logits_gives_the_plain_cross_entropy(case):
    cfg, model, batch = case[:3]
    with torch.no_grad():
        t_chunked, _ = model_apply(model, batch)
        t_plain, metrics, logits = model_apply(model, batch,
                                               return_logits=True)
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    assert logits.shape == (B, n_prefix + S, cfg.vocab)
    np.testing.assert_allclose(float(t_plain), float(t_chunked), rtol=1e-5)


def test_unknown_remat_is_refused():
    cfg = PC.get_config("llama3.2-1b", smoke=True)
    model = params_from_arrays(
        cfg, jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                       JC.get_config("llama3.2-1b",
                                                     smoke=True))),
        device="cpu", trainable=True)
    model.cfg = cfg.replace(remat="sometimes")
    with pytest.raises(ValueError, match="unknown remat"):
        model_apply(model, make_batch(cfg))


def test_arrays_from_params_inverts_params_from_arrays():
    for arch in ARCHS:
        jcfg = JC.get_config(arch, smoke=True)
        tree = jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(1), jcfg))
        model = params_from_arrays(PC.get_config(arch, smoke=True), tree,
                                   device="cpu")
        back = arrays_from_params(model.cfg, model)
        a, ta = jax.tree_util.tree_flatten(tree)
        b, tb = jax.tree_util.tree_flatten(back)
        assert ta == tb, arch
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_serving_model_takes_no_gradient_and_training_model_does():
    cfg = PC.get_config("llama3.2-1b", smoke=True)
    from repro_torch.models import init_params
    g = torch.Generator().manual_seed(0)
    serve = init_params(cfg, g, device="cpu")
    train = init_params(cfg, g, device="cpu", trainable=True)
    assert not any(p.requires_grad for p in serve.parameters())
    assert all(p.requires_grad for p in train.parameters())
