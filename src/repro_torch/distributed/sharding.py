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

One process drives one device here, so a spec is a placement that
nothing applies yet: ``constrain`` returns its input on a mesh of one
distinct device and raises ``NotImplementedError`` on more (a
``torch.distributed`` path over several GPUs is ROADMAP item 9).  The
port's model code calls no ``constrain``; item 9 adds the call sites
with that path.

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
    "state_sharding", "with_logical_rules",
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


def constrain(x, *logical):
    """``x`` placed by logical names: the spec is resolved as the JAX
    package's ``constrain`` resolves it (entries past ``x``'s rank
    dropped).  Without a mesh, or on a mesh whose devices are all one
    device, that placement is ``x`` itself.  Over several distinct
    devices it would shard ``x`` across processes, which the port cannot
    do yet (ROADMAP item 9): it raises rather than return ``x``
    unplaced."""
    spec = logical_to_spec(*logical[: x.ndim], shape=x.shape)
    if spec is None:
        return x
    devices = set(active_mesh().devices.flat)
    if len(devices) > 1:
        raise NotImplementedError(
            f"constrain{tuple(spec)} over {len(devices)} distinct devices "
            f"needs a torch.distributed path across GPUs, not ported yet "
            f"(ROADMAP item 9)")
    return x


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
