"""Carry parameters over from the JAX package.

A JAX speedup is a pytree whose leaves are its parameters.  Hand them
over as numpy arrays (``np.asarray(sp.A)`` and so on) with ``sigma`` and
``B``, and ``speedup_from_arrays`` builds the port's object from exactly
those numbers on the device asked for.  A JAX model's parameter tree,
turned to numpy leaf by leaf, goes through ``params_from_arrays`` the
same way, and ``arrays_from_params`` gives the port's parameters, or any
tensors keyed by parameter name (gradients, optimizer moments), back in
that tree's layout; ``jax_leaf_paths`` names where each parameter goes
there, and ``port_leaf_spec`` gives a parameter's sharding spec from
that leaf's.  This module reads plain arrays only; it knows nothing of
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import as_tensor, resolve_device
from .core.speedup import GenericSpeedup, RegularSpeedup, StackedSpeedup
from .distributed.sharding import PartitionSpec, param_sharding
from .models.attention import Attention
from .models.transformer import Transformer

__all__ = ["speedup_from_arrays", "params_from_arrays", "arrays_from_params",
           "jax_leaf_paths", "port_leaf_spec", "port_param_specs"]


def speedup_from_arrays(kind: str, *, B: float, A=None, w=None, gamma=None,
                        sigma=1, s_fn=None, ds_fn=None, inv_iters: int = 80,
                        device=None, dtype=torch.float64):
    """The port's speedup of class ``kind`` from arrays of its parameters.

    Args:
      kind: "RegularSpeedup", "StackedSpeedup" or "GenericSpeedup" — the
        class name on both sides.
      B: domain bound.
      A, w, gamma: parameter arrays of any shape (scalar, (M,), (N,),
        (N, M)); numpy, Python floats or tensors.
      sigma: ±1 for a RegularSpeedup; an array of ±1 for a StackedSpeedup.
      s_fn, ds_fn, inv_iters: a GenericSpeedup's callables on tensors and
        its bisection count (callables do not cross frameworks, so the
        caller writes them in torch).
      device, dtype: where the parameters live, float64 by default.
    """
    dev = resolve_device(device)
    if kind == "GenericSpeedup":
        if s_fn is None or ds_fn is None:
            raise ValueError("a GenericSpeedup needs s_fn and ds_fn")
        return GenericSpeedup(s_fn=s_fn, ds_fn=ds_fn, B=float(B),
                              inv_iters=int(inv_iters))
    leaves = dict(A=as_tensor(A, dev, dtype), w=as_tensor(w, dev, dtype),
                  gamma=as_tensor(gamma, dev, dtype))
    if kind == "RegularSpeedup":
        return RegularSpeedup(**leaves, sigma=int(sigma), B=float(B))
    if kind == "StackedSpeedup":
        return StackedSpeedup(**leaves, sigma=as_tensor(sigma, dev, dtype),
                              B=float(B))
    raise ValueError(f"unknown speedup kind {kind!r}")


def params_from_arrays(cfg, tree, device=None, dtype=None,
                       trainable=False) -> Transformer:
    """The port's model of ``cfg`` holding exactly the numbers of ``tree``.

    ``tree`` is the JAX package's ``init_params`` result with numpy
    leaves: ``embed``, ``blocks`` (one dict per cycle position, each leaf
    with a leading group axis), ``tail`` (the ``n_layers % cycle`` layers
    after the groups), ``final_norm``, ``unembed`` when untied,
    ``frontend_proj`` with a frontend, and an encoder–decoder's
    ``enc_blocks`` (one stacked cycle position of ``bidir`` layers) and
    ``enc_norm``.  Layer i < cycle·G is ``blocks[i % cycle]`` at group
    ``i // cycle``; the rest come from ``tail``.  Leaf names inside a
    layer are the JAX ones, nested as there (``norm1/scale``,
    ``mixer/wq``, ``mlp/w_gate``, ``mlp/router``, ``mlp/shared/w_up``,
    ``norm_x/scale``, ``cross/wk``, Mamba's ``mixer/in_proj`` …
    ``mixer/A_log``); attention projections are flattened from (d, H, hd)
    and (H, hd, d).  Matrices are stored in ``dtype`` (default
    ``cfg.compute_dtype``); norm scales, ``lam``, Mamba's vectors and
    ``A_log``, and the MoE router in f32.  ``trainable`` as in
    ``Transformer``.  Raises ValueError unless every parameter is filled
    and every leaf is used.
    """
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype,
                        trainable=trainable)
    known = {"embed", "blocks", "tail", "final_norm", "unembed",
             "frontend_proj", "enc_blocks", "enc_norm"}
    if set(tree) - known:
        raise ValueError(f"leaves the port has no place for: "
                         f"{sorted(set(tree) - known)}")
    filled = set()

    def put(param, arr, name):
        arr = np.asarray(arr)
        if param is None or arr.size != param.numel():
            shape = None if param is None else tuple(param.shape)
            raise ValueError(f"{name}: {arr.shape} does not fit {shape}")
        with torch.no_grad():
            param.copy_(torch.tensor(arr).reshape(param.shape))
        filled.add(id(param))

    def fill(mod, sub, group, name):
        """Copy the nested dict ``sub`` into ``mod``'s attributes of the
        same names, taking index ``group`` of each leaf when not None."""
        for key, val in sub.items():
            part = getattr(mod, key, None)
            if part is None:
                raise ValueError(f"{name}: no {key!r} in the port's "
                                 f"{type(mod).__name__}")
            if isinstance(val, dict):
                fill(part, val, group, f"{name}/{key}")
            else:
                put(part, val if group is None else val[group],
                    f"{name}/{key}")

    def fill_layers(layers, blocks, tail, cyc, name):
        G = len(layers) // cyc
        for i, blk in enumerate(layers):
            if i < cyc * G:
                fill(blk, blocks[i % cyc], i // cyc, f"{name} {i}")
            else:
                fill(blk, tail[i - cyc * G], None, f"{name} {i}")

    put(model.embed, tree["embed"], "embed")
    fill(model.final_norm, tree["final_norm"], None, "final_norm")
    for key in ("unembed", "frontend_proj"):
        if key in tree:
            put(getattr(model, key), tree[key], key)
    fill_layers(model.layers, tree["blocks"], tree["tail"], len(cfg.cycle),
                "layer")
    if "enc_blocks" in tree or "enc_norm" in tree:
        if model.enc_norm is None:
            raise ValueError(f"{cfg.name} has no encoder for the tree's "
                             f"enc_blocks and enc_norm")
        fill_layers(model.enc_layers, tree["enc_blocks"], (), 1,
                    "encoder layer")
        fill(model.enc_norm, tree["enc_norm"], None, "enc_norm")
    missing = [n for n, p in model.named_parameters()
               if id(p) not in filled]
    if missing:
        raise ValueError(f"parameters not in the tree: {missing}")
    return model


def _jax_shape(parent, leaf, x, hd):
    """A leaf's shape in the JAX tree: attention projections unflattened
    to (d, heads, hd), (heads, hd, d) and biases (heads, hd); the rest as
    the port stores them."""
    if not isinstance(parent, Attention):
        return x
    if leaf in ("wq", "wk", "wv"):
        return x.reshape(x.shape[0], -1, hd)
    if leaf == "wo":
        return x.reshape(-1, hd, x.shape[-1])
    return x.reshape(-1, hd)


def _stack(trees):
    """Nested dicts with equal structure → one dict of stacked leaves."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def arrays_from_params(cfg, model: Transformer, values=None) -> dict:
    """The inverse of ``params_from_arrays``: a JAX ``init_params``-shaped
    tree of numpy arrays (``embed``, ``blocks`` stacked per cycle
    position over the groups, ``tail``, ``final_norm``, and ``unembed``,
    ``frontend_proj``, ``enc_blocks``, ``enc_norm`` where the config has
    them).  The leaves are ``values[name]`` for each of the model's
    parameter names (gradients, optimizer moments …), or the parameters
    themselves when ``values`` is None; bf16 comes back as float32."""
    vals = dict(model.named_parameters()) if values is None else values

    def np_of(name):
        t = vals[name].detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def layer_tree(prefix, mod):
        out = {}
        for name, _ in mod.named_parameters():
            parts = name.split(".")
            parent = mod.get_submodule(".".join(parts[:-1]))
            node = out
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = _jax_shape(parent, parts[-1],
                                         np_of(prefix + name), cfg.head_dim)
        return out

    def stack_layers(prefix, layers, cyc):
        G = len(layers) // cyc
        trees = [layer_tree(f"{prefix}.{i}.", blk)
                 for i, blk in enumerate(layers)]
        blocks = tuple(_stack([trees[g * cyc + j] for g in range(G)])
                       for j in range(cyc)) if G else ()
        return blocks, tuple(trees[cyc * G:])

    tree = {"embed": np_of("embed"),
            "final_norm": layer_tree("final_norm.", model.final_norm)}
    tree["blocks"], tree["tail"] = stack_layers("layers", model.layers,
                                                len(cfg.cycle))
    for key in ("unembed", "frontend_proj"):
        if getattr(model, key) is not None:
            tree[key] = np_of(key)
    if model.enc_norm is not None:
        tree["enc_blocks"], _ = stack_layers("enc_layers", model.enc_layers,
                                             1)
        tree["enc_norm"] = layer_tree("enc_norm.", model.enc_norm)
    return tree


def jax_leaf_paths(cfg, model: Transformer) -> dict:
    """Where ``arrays_from_params`` puts each of the model's parameters,
    computed from shapes alone: {name: (path, shape, stacked)}, the path
    the JAX tree's leaf string (``blocks/0/mixer/wq``: keys and tuple
    indices joined by "/"), its shape there, and ``stacked`` the number
    of leading axes over the block pattern's repeats (1 in ``blocks`` and
    ``enc_blocks``, else 0)."""
    out = {}
    params = dict(model.named_parameters())

    def put(name, path, parent, leaf, lead=()):
        x = torch.empty(params[name].shape, device="meta")
        shape = tuple(_jax_shape(parent, leaf, x, cfg.head_dim).shape)
        out[name] = ("/".join(path), lead + shape, len(lead))

    def layers(prefix, mods, cyc, stacked_key, tail_key):
        G = len(mods) // cyc
        for i, blk in enumerate(mods):
            head, lead = (([stacked_key, str(i % cyc)], (G,)) if i < G * cyc
                          else ([tail_key, str(i - G * cyc)], ()))
            for sub, _ in blk.named_parameters():
                parts = sub.split(".")
                put(f"{prefix}.{i}.{sub}", head + parts,
                    blk.get_submodule(".".join(parts[:-1])), parts[-1], lead)

    for name, _ in model.named_parameters(recurse=False):
        put(name, [name], model, name)
    for key in ("final_norm", "enc_norm"):
        mod = getattr(model, key)
        if mod is not None:
            for sub, _ in mod.named_parameters():
                put(f"{key}.{sub}", [key, sub], mod, sub)
    layers("layers", model.layers, len(cfg.cycle), "blocks", "tail")
    layers("enc_layers", model.enc_layers, 1, "enc_blocks", None)
    return out


def _merged(head, width):
    """The entry of a flattened (heads·hd) axis from the heads' and the
    head width's: the heads' where the width is whole, as in every
    projection; a bias whose width is sharded (the generic rule's largest
    axis) gives its axes to the flattened axis after the heads', which
    keeps the shards' sizes, not the order of their elements."""
    axes = tuple(a for e in (head, width) if e is not None
                 for a in (e if isinstance(e, tuple) else (e,)))
    return None if not axes else axes[0] if len(axes) == 1 else axes


def port_leaf_spec(path: str, spec, stacked: int = 0) -> PartitionSpec:
    """A port parameter's spec from its JAX leaf's (``path`` and
    ``stacked`` as ``jax_leaf_paths`` gives them): the ``stacked``
    leading entries dropped, and for the attention projections, which
    the port stores flattened, (H, hd) merged into the heads' entry —
    wq/wk/wv (d, H, hd) → (d, H·hd), wo (H, hd, d) → (H·hd, d), the
    biases (H, hd) → (H·hd,)."""
    spec = tuple(spec or ())[stacked:]
    if not spec:
        return PartitionSpec()
    name = path.split("/")[-1]
    if name in ("wq", "wk", "wv"):
        spec = (spec[0], _merged(spec[1], spec[2]))
    elif name == "wo":
        spec = (_merged(spec[0], spec[1]), spec[2])
    elif name in ("bq", "bk", "bv"):
        spec = (_merged(spec[0], spec[1]),)
    return PartitionSpec(*spec)


def port_param_specs(cfg, model: Transformer) -> dict:
    """{parameter name: spec} of ``model`` on the active mesh: the spec
    ``param_sharding`` gives the same leaf of the JAX package's tree (by
    its path and shape there), through ``port_leaf_spec``."""
    return {name: port_leaf_spec(path, param_sharding(path, shape), stacked)
            for name, (path, shape, stacked)
            in jax_leaf_paths(cfg, model).items()}
