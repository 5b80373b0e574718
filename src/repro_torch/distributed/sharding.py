"""Device meshes and the logical-axis sharding rules (MaxText-style).

``FleetMesh`` is the port's mesh: an array of ``torch.device`` entries
with one axis name per array dimension.  Used as a context manager it
pushes itself on a module-level stack, and ``active_mesh()`` returns the
innermost one, else the process-wide mesh of ``set_mesh`` — the
counterpart of the JAX package's ``with Mesh(...)`` context and
``jax.sharding.set_mesh``, without a process group.  The fleet layer
(``distributed/fleet.py``) reads a 1-D mesh to shard the instance axis.

Model code names tensor axes by *logical* names ("batch", "heads",
"ff", …); ``logical_to_spec`` resolves them against the axes of the
active mesh (its ``axis_names`` and ``devices.shape``) under the rules
of the innermost ``with_logical_rules`` (``LOGICAL_RULES`` by default,
``POLICIES`` by name), with the JAX package's greedy prefix fallback
where a dimension does not divide.  ``param_sharding`` and
``state_sharding`` give a parameter's and a decode-state leaf's spec
from its path string and shape, as the JAX functions do, so both
packages answer the same question on the same inputs.  A spec is a
``PartitionSpec``: a tuple whose entries are None, a mesh-axis name or a
tuple of names, equal entry by entry to the tuple of a JAX ``P``.

A spec becomes ``DTensor`` placements on a ``DeviceMesh`` whose
dimensions are the mesh's axes through ``spec_to_placements``.  The dry
run over a mesh (``launch/dryrun.py``) places its meta leaves so, and
``constrain`` redistributes a DTensor to its resolved spec; the model
code calls ``constrain`` where the JAX package does.  On a plain tensor
``constrain`` returns its input without a mesh or on a mesh of one
distinct device, and raises ``NotImplementedError`` over several
distinct devices: executing over several GPUs is ROADMAP item 9(c).
Where DTensor, left to itself, would partition the model otherwise than
the JAX package's partitioner does, the model calls a helper that is
the plain operation on plain tensors: ``sharded_lookup`` (embedding
rows), ``take_last`` (the gold logit), ``logsumexp_last`` (over a
vocabulary shard) and ``batch_like`` (positions split as the batch).  The dry run reads each FSDP-sharded weight
gathered where a layer uses it (``launch/dryrun._FsdpGathered``).

Sharding scheme (``LOGICAL_RULES``):
  batch     → ("pod", "data")   DP across pods and hosts
  fsdp      → "data"            parameter / optimizer-state FSDP shards
  heads     → "model"           TP over attention heads
  kv_heads  → "model"           TP over KV heads (when divisible)
  ff        → "model"           TP over FFN hidden
  vocab     → "model"           TP over embedding / logits vocab
  seq_mp    → "model"           sequence parallelism for the residual
                                stream / long KV caches
  expert    → "model"           expert parallelism (when divisible)
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

__all__ = [
    "FleetMesh", "LOGICAL_RULES", "NamedSharding", "PartitionSpec",
    "POLICIES",
    "ZERO3_RULES", "active_mesh", "constrain", "heads_shardable",
    "logical_to_spec", "mesh_axis_size", "param_sharding", "set_mesh",
    "batch_like", "logical_axes", "logsumexp_last", "sharded_lookup",
    "spec_to_placements", "take_last",
    "state_sharding",
    "with_logical_rules",
]

_ACTIVE: list = []
_DEFAULT: list = [None]     # the mesh of ``set_mesh``


class FleetMesh:
    """An n-D array of devices with one name per axis.

    ``devices`` is a numpy object array of ``torch.device``; the same
    device may appear more than once (several shards on one host device,
    the port's counterpart of the JAX package's forced host devices).
    """

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        flat = np.asarray(devices, dtype=object).reshape(-1)
        arr.reshape(-1)[:] = [torch.device(d) for d in flat]
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-D devices need {arr.ndim} axis "
                             f"names, got {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def __repr__(self):
        return (f"FleetMesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def active_mesh():
    """The mesh of the innermost active ``with FleetMesh(...)``, else the
    one ``set_mesh`` installed, else None."""
    return _ACTIVE[-1] if _ACTIVE else _DEFAULT[0]


def set_mesh(mesh):
    """Install ``mesh`` as the process-wide mesh (``active_mesh`` returns
    it outside any ``with FleetMesh(...)``); None clears it.  Returns the
    mesh."""
    if mesh is not None and not isinstance(mesh, FleetMesh):
        raise TypeError(f"set_mesh takes a FleetMesh or None, got "
                        f"{type(mesh).__name__}")
    _DEFAULT[0] = mesh
    return mesh


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh-axis name, or a
    tuple of names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A leaf's placement: ``spec`` over the axes of ``mesh`` (the JAX
    ``NamedSharding(mesh, spec)``)."""

    def __init__(self, mesh: FleetMesh, spec=None):
        self.mesh = mesh
        self.spec = PartitionSpec(*(spec or ()))

    @property
    def device(self) -> torch.device:
        """The one device that holds the whole leaf.  Raises
        ``NotImplementedError`` where the spec shards over a mesh axis of
        more than one entry, or the mesh spans several distinct devices:
        either needs a torch.distributed path across GPUs, not ported yet
        (ROADMAP item 9)."""
        size = self.mesh.shape
        for entry in self.spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None and size.get(ax, 1) > 1:
                    raise NotImplementedError(
                        f"{self.spec} shards over mesh axis {ax!r} of size "
                        f"{size[ax]}: that needs a torch.distributed path "
                        f"across GPUs, not ported yet (ROADMAP item 9)")
        devices = set(self.mesh.devices.flat)
        if len(devices) > 1:
            raise NotImplementedError(
                f"a placement over {len(devices)} distinct devices needs a "
                f"torch.distributed path across GPUs, not ported yet "
                f"(ROADMAP item 9)")
        return next(iter(devices))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "seq_mp": ("model",),
    "replicated": (),
}

# ZeRO-3: pure FSDP over the flattened device grid — batch and parameter
# shards span BOTH axes, no tensor parallelism.  Attention/FFN compute is
# fully local; the only collectives are per-layer parameter (re)gathers.
# The right policy when TP would replicate compute (heads % mesh != 0).
ZERO3_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data", "model"),
    "fsdp": ("data", "model"),
    "heads": (),
    "kv_heads": (),
    "ff": (),
    "vocab": (),
    "expert": (),
    "seq_mp": (),
    "replicated": (),
}

POLICIES = {"dp_tp": LOGICAL_RULES, "zero3": ZERO3_RULES}

_local = threading.local()


def _rules():
    return getattr(_local, "rules", LOGICAL_RULES)


def logical_axes(name: str) -> tuple[str, ...]:
    """The mesh axes the logical ``name`` maps to under the active
    rules."""
    return tuple(_rules().get(name, ()))


@contextlib.contextmanager
def with_logical_rules(overrides: dict[str, tuple[str, ...]]):
    """Temporarily override logical→mesh rules (this thread only)."""
    old = _rules()
    _local.rules = {**old, **overrides}
    try:
        yield
    finally:
        _local.rules = old


def _mesh_axes():
    """(axis names, {name: size}) of the active mesh, or None."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return set(mesh.axis_names), dict(zip(mesh.axis_names,
                                          mesh.devices.shape))


def logical_to_spec(*logical, shape=None) -> PartitionSpec | None:
    """Resolve logical axis names to a PartitionSpec for the active mesh.

    Each entry is a logical name, a tuple of logical names, or None.  A
    name's mesh axes are its rule's axes that the mesh has and that no
    earlier dimension took.  If ``shape`` is given, a dimension not
    divisible by the product of its axes' sizes drops axes from the end
    until it divides (the greedy prefix fallback: a 151936-row embedding
    shards 16-way over "data" when 256-way fails; 60 experts on a 16-way
    axis replicate).  Returns None when no mesh is active.
    """
    present = _mesh_axes()
    if present is None:
        return None
    axes_set, axis_size = present
    rules = _rules()
    spec = []
    used: set[str] = set()
    for dim, name in enumerate(logical):
        if name is None:
            spec.append(None)
            continue
        names = name if isinstance(name, tuple) else (name,)
        mesh_axes: list[str] = []
        for n in names:
            for ax in rules.get(n, ()):
                if ax in axes_set and ax not in used:
                    mesh_axes.append(ax)
        if shape is not None:
            while mesh_axes and shape[dim] % math.prod(
                    axis_size[a] for a in mesh_axes):
                mesh_axes = mesh_axes[:-1]
        used.update(mesh_axes)
        if not mesh_axes:
            spec.append(None)
        elif len(mesh_axes) == 1:
            spec.append(mesh_axes[0])
        else:
            spec.append(tuple(mesh_axes))
    return PartitionSpec(*spec)


def mesh_axis_size(axis: str) -> int:
    """The active mesh's size along ``axis`` (1 without a mesh or axis)."""
    present = _mesh_axes()
    if present is None:
        return 1
    return present[1].get(axis, 1)


def heads_shardable(n_heads: int) -> bool:
    """True when TP over heads divides the model axis — otherwise
    attention falls back to sequence parallelism (context-parallel
    attention) so its compute still shards 'model'-ways."""
    return n_heads % mesh_axis_size("model") == 0


def spec_to_placements(spec, axis_names):
    """DTensor placements, one a mesh dimension, of ``spec`` on a
    ``DeviceMesh`` whose dimensions are ``axis_names`` (a ``FleetMesh``'s
    axes, in order).  A tensor dimension whose entry names an axis is
    ``Shard(dim)`` on that mesh dimension; an entry that is a tuple of
    axes shards its dimension over all of them, the first the major one,
    as JAX splits it, which is DTensor's split when the tuple is in mesh
    order (a tuple out of mesh order raises ValueError).  Every other
    mesh dimension is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    axis_names = tuple(axis_names)
    out = [Replicate()] * len(axis_names)
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry} shards dimension {dim} over mesh "
                             f"axes out of the mesh's order {axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {axis_names[i]!r} appears "
                                 f"twice in {spec}")
            out[i] = Shard(dim)
    return out


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh")


def constrain(x, *logical):
    """``x`` placed by logical names: the spec is resolved as the JAX
    package's ``constrain`` resolves it (entries past ``x``'s rank
    dropped).  A ``DTensor`` is redistributed to that spec on its own
    mesh (``spec_to_placements``), which has the active mesh's axes.  A
    plain tensor without a mesh, or on a mesh whose devices are all one
    device, is returned itself; over several distinct devices it would
    shard ``x`` across processes, which the port does not run yet
    (ROADMAP item 9(c)): it raises rather than return ``x`` unplaced."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not _is_dtensor(x):
        if mesh.size == 1 or len(set(mesh.devices.flat)) == 1:
            return x
        raise NotImplementedError(
            f"constrain{tuple(logical)} over {len(set(mesh.devices.flat))} "
            f"distinct devices needs a torch.distributed path across GPUs, "
            f"not ported yet (ROADMAP item 9(c))")
    spec = logical_to_spec(*logical[: x.ndim], shape=x.shape)
    placements = tuple(spec_to_placements(spec, x.device_mesh.mesh_dim_names))
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """A ``DTensor`` redistributed to ``placements``, and its cotangent
    to the same placements in the backward: JAX transposes a sharding
    constraint into the same constraint on the cotangent, so a partial
    sum that reaches a constrained point in the backward pass is reduced
    there, not carried on into the products before it."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        out = x.redistribute(x.device_mesh, placements)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g, None
        return g.redistribute(g.device_mesh, ctx.placements), None


def batch_like(t, ref):
    """``t`` (rows first, every row alike, such as the positions of a
    batch) split over the mesh axes that split ``ref``'s rows where
    ``ref`` is a ``DTensor`` (this rank's rows, not the whole batch on
    every rank); else ``t`` itself."""
    if not _is_dtensor(ref) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    placements = [p if p.is_shard() and p.dim == 0 else Replicate()
                  for p in ref.placements]
    rows = ref.to_local().shape[0]
    return DTensor.from_local(t.narrow(0, 0, rows), ref.device_mesh,
                              placements, run_check=False)


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` over DTensors as the JAX package's partitioner
    runs it: the table gathered whole on every rank, each rank's rows
    looked up from its own tokens; in the backward each rank scatters
    the gradient rows it holds (the tokens split as they are) into a
    table of its own: the gradient is that partial sum over the mesh
    axes that split those rows, which the table's own redistribution
    (or ``loss_and_grads``) reduces to the parameter's placement."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = table.device_mesh
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        ctx.tokens = tokens
        ctx.meta = (table.shape, mesh)
        return DTensor.from_local(whole.to_local()[tokens.to_local()], mesh,
                                  tokens.placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        shape, mesh = ctx.meta
        rows = ctx.tokens.ndim
        split = [p if p.is_shard() and p.dim < rows else Replicate()
                 for p in grad.placements]
        g = grad.redistribute(mesh, split).to_local()
        idx = ctx.tokens.redistribute(mesh, split).to_local()
        local = g.new_zeros(shape).index_put_((idx,), g, accumulate=True)
        return DTensor.from_local(
            local, mesh, [Partial() if p.is_shard() else Replicate()
                          for p in split], run_check=False), None


def sharded_lookup(table, tokens):
    """``table[tokens]`` (rows of an embedding table) where ``table`` is a
    ``DTensor``: see ``_Lookup``.  DTensor's own indexing gathers every
    rank's tokens and gradient rows in the backward instead."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, table.device_mesh,
                                    [Replicate()] * table.device_mesh.ndim,
                                    run_check=False)
    return _Lookup.apply(table, tokens)


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``.  Over a ``DTensor`` whose last axis is
    split (a vocabulary shard) each rank takes the max and the sum of
    exponentials of its own shard, reduced across the split, as the JAX
    package's partitioner reduces them; DTensor's own logsumexp gathers
    the whole axis on every rank."""
    last = x.ndim - 1
    if not _is_dtensor(x) or not any(p.is_shard() and p.dim == last
                                     for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Replicate

    def reduced(t):                     # a partial max or sum, reduced
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])

    m = reduced(x.detach().amax(dim=-1, keepdim=True))
    return m[..., 0] + torch.log(reduced(torch.exp(x - m).sum(dim=-1)))


class _TakeLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` over DTensors as the JAX package's
    partitioner runs it: each rank takes from its own shard of x, the
    entries outside a vocabulary shard (x's last axis split over a mesh
    axis) read as zeros and the result a partial sum over that axis; in
    the backward each rank scatters into its own shard.  DTensor's own
    gather builds a zero gradient of x's global shape on every rank."""

    @staticmethod
    def forward(ctx, x, idx):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, last = x.device_mesh, x.ndim - 1
        split = [p.is_shard() and p.dim == last for p in x.placements]
        want = [Replicate() if s else p for s, p in zip(split, x.placements)]
        if not isinstance(idx, DTensor):
            idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        li = idx.redistribute(mesh, want).to_local()
        loc = x.to_local()
        lo, width = 0, x.shape[last]
        coord = mesh.get_coordinate()
        for i, s in enumerate(split):       # shards major first, mesh order
            if s:
                width //= mesh.size(i)
                lo += coord[i] * width
        inside = (li >= lo) & (li < lo + loc.shape[-1])
        at = (li - lo).clamp(0, loc.shape[-1] - 1)
        ctx.save_for_backward(at, inside)
        ctx.meta = (loc.shape, x.placements, mesh, want)
        out = torch.where(inside, torch.gather(loc, -1, at), 0.0)
        return DTensor.from_local(
            out, mesh, [Partial() if s else p for s, p in zip(split, want)],
            run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        at, inside = ctx.saved_tensors
        shape, placements, mesh, want = ctx.meta
        g = grad.redistribute(mesh, want).to_local()
        d = g.new_zeros(shape).scatter_(-1, at, torch.where(inside, g, 0.0))
        return DTensor.from_local(d, mesh, placements, run_check=False), None


def take_last(x, idx):
    """``torch.gather(x, -1, idx)``; over a ``DTensor`` x, ``_TakeLast``."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, idx)
    return _TakeLast.apply(x, idx)


def param_sharding(path: str, shape) -> PartitionSpec | None:
    """Sharding spec for a parameter by naming convention (the JAX
    package's path string, e.g. ``blocks/0/mixer/wq``, and shape).

    Conventions (see models/): parameter dict keys encode their role —
      wq/wk/wv/wo       attention projections
      w_gate/w_up/w_down FFN
      embed / unembed    vocab tables
      experts…           MoE stacks (leading expert dim)
    Everything 2D+ also gets FSDP on its largest remaining dim.
    """
    name = path.split("/")[-1]
    ndim = len(shape)

    def spec_of(*logical):
        return logical_to_spec(*logical, shape=shape)

    if ndim == 0:
        return spec_of()
    if name in ("embed", "unembed"):
        # (vocab, d_model) — vocab TP + FSDP on d_model
        return spec_of("vocab", "fsdp")
    if name in ("wq", "wk", "wv"):
        # (d_model, heads, head_dim) or stacked (L, d_model, H, hd)
        return spec_of(*((None,) * (ndim - 3) + ("fsdp", "heads", None)))
    if name == "wo":
        return spec_of(*((None,) * (ndim - 3) + ("heads", None, "fsdp")))
    if name in ("w_gate", "w_up"):
        return spec_of(*((None,) * (ndim - 2) + ("fsdp", "ff")))
    if name == "w_down":
        return spec_of(*((None,) * (ndim - 2) + ("ff", "fsdp")))
    if name.startswith("expert_"):
        # (…, E, d, f) stacks: expert-parallel when divisible, else TP on f
        base = (("expert", "ff", "fsdp") if name.endswith("_down")
                else ("expert", "fsdp", "ff"))
        return spec_of(*((None,) * (ndim - 3) + base))
    if ndim >= 2:
        # generic 2D+: FSDP along the largest dim
        logical = [None] * ndim
        logical[int(np.argmax(shape))] = "fsdp"
        return spec_of(*logical)
    return spec_of(*([None] * ndim))


def state_sharding(path: str, shape) -> PartitionSpec | None:
    """Sharding for decode-state leaves (KV caches, SSM states), by the
    JAX package's path string and shape.

    KV caches (…, B, C, K, hd): batch-DP always; TP over KV heads when
    divisible, else over the cache length (flash-decoding style).  SSM
    states (…, B, di[, N]) and conv windows shard the feature dim.
    Leading stack dims (scan groups) stay unsharded.
    """
    present = _mesh_axes()
    if present is None:
        return None
    model = present[1].get("model", 1)
    name = path.split("/")[-1]
    ndim = len(shape)

    def spec_of(*logical):
        return logical_to_spec(*logical, shape=shape)

    if name in ("k", "v") and ndim >= 4:
        base = (("batch", None, "kv_heads", None) if shape[-2] % model == 0
                else ("batch", "seq_mp", None, None))
        return spec_of(*((None,) * (ndim - 4) + base))
    if name == "h" and ndim >= 2:
        if ndim >= 3 and shape[-1] <= 64:      # (…, B, di, N): shard di
            return spec_of(*((None,) * (ndim - 3) + ("batch", "ff", None)))
        return spec_of(*((None,) * (ndim - 2) + ("batch", "ff")))
    if name == "conv" and ndim >= 3:
        return spec_of(*((None,) * (ndim - 3) + ("batch", None, "ff")))
    if name == "pos":
        return spec_of()
    if ndim >= 4:                              # cross-attention K/V stacks
        return spec_of(*((None,) * (ndim - 4) + ("batch", None, None, None)))
    if ndim >= 1:
        return spec_of(*(("batch",) + (None,) * (ndim - 1)))
    return spec_of()
