"""Cost analysis of a program traced on the meta device.

The JAX package's ``launch/hlo_analysis.py`` parses the compiled HLO of
a program.  The port has no HLO: ``trace_program`` runs the program on
**meta** tensors (shapes and dtypes, no storage, no launch) under a
``TorchDispatchMode`` and counts each aten operation as the dispatcher
sees it, by the reference's rules:

  flops        products (mm, addmm, bmm, baddbmm):
               2·|result|·|contracting|; elementwise and transcendental
               ops: |result|; reductions: max(|input|, |result|)
  bytes        HBM-traffic model: Σ over the ops that materialise a
               result of operand + result bytes.  Views (view, expand,
               permute, slice, select, detach, …) and fresh allocations
               move nothing; index_select, gather, embedding and advanced
               indexing read only the rows they return; index_put,
               scatter and index_add write only the rows they are given
  bytes_fused  lower bound: only the ops a backend cannot fuse away
               contribute — products, copies and casts, gathers and
               scatters, sort, reductions, collectives and the K5
               stand-ins
  collectives  the ``_c10d_functional`` collectives of a program over
               ``DTensor``s, under the reference's names: count and
               result bytes by op (all_gather_into_tensor → all-gather,
               all_reduce → all-reduce, reduce_scatter_tensor →
               reduce-scatter, all_to_all_single → all-to-all, a
               send/recv pair → collective-permute, counted once at its
               irecv); none on a program of plain tensors (one device)

The reference expands each while loop by its trip count; here a Python
loop runs its body once an iteration, so each iteration is counted as
it runs (``while_trips`` stays empty).  ``trace_program`` also tracks
the bytes of every storage an operation allocates, from the operation
to its release: the peak of those live intermediates is the
counterpart of XLA's temp size.

Every tensor the program is given must be on meta, and so must every
operand the mode sees: the port's CUDA kernels are ``ctypes`` calls that
the dispatcher never sees (``kernels/_build.py``), so a count on the
card would leave K4 and K5 out.  On meta, ``flash_attention_op`` runs
K5's stand-ins (``kernels/flash_attention/meta.py``), which allocate
what K5 and its backward allocate, and are counted by name: the
products the kernels compute over the tiles they visit
(``k5_product_flops``), each operand read and each output written once.
``linear_scan_op`` takes its plain version by its device rule.

Per device.  A program whose tensors are ``DTensor``s with shards on
meta (``launch/dryrun.py`` over a mesh, under a fake process group) is
counted on one rank: the mode lets each DTensor operation dispatch on
with the mode still active, so what it counts are the local operations
DTensor runs on the rank's shards and the collectives of its
redistributions, not the global operation; the shape propagation
DTensor runs under a fake-tensor mode is not counted, nor, inside
``host_ops_pass()``, the integer host tensors its placement rules
build (a float tensor off meta still raises).  A K5 stand-in's call on
a shard counts its share of the global call's walk: the global call's
product flops times the share of its query elements (batch rows, heads,
query rows) the shard holds.  That is the local walk itself for batch
and head shards; for query-sequence shards under a causal mask it is
the mean over the ranks, where the local walk from position 0 would be
rank 0's, the lightest.  ``ProgramMemory`` reads the shards' storages:
per-device argument, output and temp bytes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from collections import Counter

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.flash_attention.meta import META_OPS, k5_product_flops

__all__ = ["analyze_program", "HloCost", "ProgramMemory", "host_ops_pass",
           "top_contributors", "trace_program"]

# the aten ops of the port's programs, by how the reference counts them;
# any other op moves its operand and result bytes and counts no flops
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
_ELEMWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "reciprocal",
    "remainder", "maximum", "minimum", "clamp", "clamp_min", "where", "eq",
    "ne", "lt", "le", "gt", "ge", "bitwise_and", "bitwise_or",
    "bitwise_not",
}
_TRANSCENDENTAL = {
    "exp", "log", "logaddexp", "tanh", "rsqrt", "sqrt", "pow", "sin", "cos",
    "sigmoid", "silu", "gelu", "softplus", "tanh_backward",
    "sigmoid_backward", "silu_backward", "gelu_backward",
    "softplus_backward",
}
_REDUCTIONS = {"sum", "mean", "amax", "max", "all", "any", "logsumexp",
               "cumsum", "_softmax", "_softmax_backward_data"}
_GATHERS = {"index_select", "gather", "embedding", "index"}
_SCATTERS = {"index_put", "scatter", "scatter_add", "index_add",
             "index_copy", "embedding_dense_backward"}
_COPIES = {"copy", "_to_copy", "clone", "cat", "stack", "constant_pad_nd",
           "select_backward", "slice_backward"}
_SORTS = {"sort", "topk"}
# allocations that write nothing, and ops that only alias
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "view",
         "_unsafe_view", "wait_tensor", "_wrap_tensor_autograd"}
# the functional collectives by the reference's names (its _COLLECTIVES)
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                # a send/recv pair once, at the receive
                "irecv": "collective-permute"}
_C10D = ("_c10d_functional", "_c10d_functional_autograd")
_FAKE = torch._C._TorchDispatchModeKey.FAKE


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_fused: float = 0.0   # lower bound: elementwise chains fused away
    transcendentals: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Counter = dataclasses.field(default_factory=Counter)
    collective_bytes_by_op: Counter = dataclasses.field(default_factory=Counter)
    while_trips: dict = dataclasses.field(default_factory=dict)
    # the port's own split of ``flops``: the products (the reference's
    # dots), and of those the K5 stand-ins'
    product_flops: float = 0.0
    attention_flops: float = 0.0


@dataclasses.dataclass
class ProgramMemory:
    """Bytes of the program's tensor arguments (modules' parameters and
    buffers included, each storage once), of its tensor outputs that it
    allocated, and the peak of its live intermediates."""
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _arg_tensors(args, kwargs):
    """Every tensor the call is given: leaves of the arguments' pytrees
    (dicts, lists, tuples, named tuples) and each module's parameters and
    buffers."""
    leaves, _ = tree_flatten((args, kwargs))
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, nn.Module):
            out += list(x.parameters()) + list(x.buffers())
    return out


def _local(t):
    """A DTensor's shard on this rank; any other tensor itself."""
    loc = getattr(t, "_local_tensor", None)
    return t if loc is None else loc


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        s = _local(t).untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _collective(func):
    """The reference's name of a functional collective, else None."""
    if func.namespace in _C10D:
        return _COLLECTIVES.get(func.overloadpacket.__name__)
    return None


def _op_cost(func, args, kwargs, out, k5_call=None):
    """(flops, transcendentals, bytes, bytes_fused, product flops,
    collective bytes) of one dispatched operation; ``k5_call`` is the
    (product flops, query elements) of the global call a K5 stand-in's
    local call on a shard runs for."""
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") else name
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if func.is_view or base in _FREE or not outs:
        return 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    relems = sum(t.numel() for t in outs)
    rbytes = sum(_nbytes(t) for t in outs)
    flops = trans = prod = 0.0
    kind = META_OPS.get(func)
    coll = _collective(func)
    if kind is not None:
        if k5_call is None:
            prod = flops = _k5_flops(func, args)
        else:                           # this shard's share of the call
            whole, q_elems = k5_call
            prod = flops = whole * args[0].numel() / q_elems
    elif base in _PRODUCTS:
        # mm/bmm (a, b), addmm/baddbmm (c, a, b): a's last axis contracts
        a = args[0] if base in ("mm", "bmm") else args[1]
        prod = 2.0 * outs[0].numel() * a.shape[-1]
        flops = prod + (relems if base in ("addmm", "baddbmm") else 0)
    elif base in _ELEMWISE:
        flops = relems
    elif base in _TRANSCENDENTAL:
        flops = trans = relems
    elif base in _REDUCTIONS:
        flops = max(max((t.numel() for t in ins), default=0), relems)
    # ---- bytes ----
    if base in _GATHERS:
        idx = sum(_nbytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        ob = rbytes + idx               # the rows returned, and the index
    elif base in _SCATTERS:
        moved = ins[1:]
        ob = sum(_nbytes(t) for t in moved)
        vals = sum(_nbytes(t) for t in moved if t.is_floating_point())
        rbytes = vals or rbytes         # only the rows written
    elif base in ("copy", "fill", "zero"):
        ob = sum(_nbytes(t) for t in ins[1:])   # the target is not read
    else:
        ob = sum(_nbytes(t) for t in ins)
    nbytes = float(rbytes + ob)
    fused = nbytes if (base in _PRODUCTS or base in _COPIES
                       or base in _GATHERS or base in _SCATTERS
                       or base in _SORTS or base in _REDUCTIONS
                       or kind is not None or coll is not None) else 0.0
    return (float(flops), float(trans), nbytes, fused, prod,
            float(rbytes) if coll is not None else 0.0)


def _k5_flops(func, args):
    """``k5_product_flops`` of a K5 stand-in's call (its tensors' shapes
    as they are given: a DTensor's global ones)."""
    kind = META_OPS[func]
    causal, window = args[3:5] if kind == "fwd" else args[5:7]
    return k5_product_flops(kind, args[0], args[1], causal, window)


_AUTOGRAD = "torch/autograd/"
_HOST_OPS_PASS = [False]


def _bookkeeping(t) -> bool:
    """A host tensor ``host_ops_pass`` lets through: integer or bool."""
    return (t.device.type == "cpu" and not t.is_floating_point()
            and not t.is_complex())


@contextlib.contextmanager
def host_ops_pass():
    """Inside the block the count lets an operation on integer or
    boolean host tensors run uncounted instead of raising: a trace over
    ``DTensor``s, whose inputs are all on meta, meets such tensors in
    DTensor's own bookkeeping (a shard's mesh coordinate, the shards'
    sizes and offsets, a mesh's size long).  A float tensor off meta
    still raises."""
    old = _HOST_OPS_PASS[0]
    _HOST_OPS_PASS[0] = True
    try:
        yield
    finally:
        _HOST_OPS_PASS[0] = old


def _module_names(root):
    return {id(m): n for n, m in root.named_modules()}


class _Tracer(TorchDispatchMode):
    """Counts each dispatched op; with ``rows`` it also keeps one row an
    op with the module that issued it."""

    def __init__(self, rows=None):
        super().__init__()
        self.cost = HloCost()
        self.rows = rows
        self.live = 0
        self.peak = 0
        self.owned: set = set()
        self._names = weakref.WeakKeyDictionary()
        self.k5_calls: list = []

    def _release(self, key, n):
        self.live -= n
        self.owned.discard(key)

    def _track(self, outs, ins):
        """Count the storages ``outs`` newly hold (not an input's)."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in held or key in self.owned:
                continue
            n = s.nbytes()
            self.owned.add(key)
            self.live += n
            weakref.finalize(s, self._release, key, n)
        self.peak = max(self.peak, self.live)

    def _issuer(self):
        """The qualified name of the innermost ``nn.Module`` argument of a
        frame on the stack, under the outermost module that holds it;
        autograd's node for an op the backward pass issues."""
        inner, roots = None, []
        f = sys._getframe(2)
        while f is not None:
            code = f.f_code
            if inner is None and _AUTOGRAD in code.co_filename:
                break                   # the engine issued it, not a forward
            for v in code.co_varnames[:code.co_argcount]:
                m = f.f_locals.get(v)
                if isinstance(m, nn.Module):
                    if inner is None:
                        inner = m
                    roots.append(m)
                    break
            f = f.f_back
        if inner is None:
            node = torch._C._current_autograd_node()
            return f"<{node.name()}>" if node is not None else ""
        for root in reversed(roots):
            names = self._names.get(root)
            if names is None:
                names = self._names[root] = _module_names(root)
            if id(inner) in names:
                return names[id(inner)] or type(root).__name__
        return type(inner).__name__

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's shape propagation (global shapes, fake tensors)
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            # a DTensor operation: DTensor runs its local operations and
            # redistributions with this mode active, and those are counted;
            # a K5 stand-in's local call counts its share of the global
            # call's walk
            if func in META_OPS:
                self.k5_calls.append((func, (_k5_flops(func, args),
                                             args[0].numel())))
            return NotImplemented
        ins = _tensors((args, kwargs))
        for t in ins:
            if t.device.type != "meta":
                if _HOST_OPS_PASS[0] and all(
                        u.device.type == "meta" or _bookkeeping(u)
                        for u in ins):
                    return func(*args, **kwargs)
                raise ValueError(
                    f"{func} got a tensor on {t.device}: the count runs on "
                    f"meta tensors only (a CUDA kernel's launch is a ctypes "
                    f"call the dispatcher never sees)")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        k5_call = None
        if func in META_OPS and self.k5_calls and \
                self.k5_calls[-1][0] is func:
            k5_call = self.k5_calls.pop()[1]
        flops, trans, nbytes, fused, prod, coll = _op_cost(
            func, args, kwargs, out, k5_call)
        c = self.cost
        c.flops += flops
        c.transcendentals += trans
        c.bytes += nbytes
        c.bytes_fused += fused
        c.product_flops += prod
        if func in META_OPS:
            c.attention_flops += prod
        if coll:
            ref = _collective(func)
            c.collective_bytes += coll
            c.collective_counts[ref] += 1
            c.collective_bytes_by_op[ref] += coll
        if not func.is_view:
            self._track(outs, ins)
        if self.rows is not None and (nbytes or flops):
            shape = ",".join(f"{str(t.dtype)[6:]}{list(t.shape)}"
                             for t in outs)
            self.rows.append({"bytes": nbytes, "flops": prod,
                              "collective": coll,
                              "op": func.overloadpacket.__name__,
                              "overload": str(func), "type": shape[:80],
                              "module": self._issuer()})
        return out


def _check_meta(tensors):
    for t in tensors:
        if t.device.type != "meta":
            raise ValueError(
                f"analyze_program counts meta tensors only; got a tensor on "
                f"{t.device} (the port's CUDA kernels are ctypes calls the "
                f"dispatcher never sees, so a count on the card would leave "
                f"them out)")


def _run(tracer, fn, args, kwargs):
    given = _arg_tensors(args, kwargs)
    _check_meta(given)
    with tracer:
        out = fn(*args, **kwargs)
    return given, out


def trace_program(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on meta tensors under the counting
    mode.  Returns (HloCost, ProgramMemory, the program's output)."""
    tracer = _Tracer()
    given, out = _run(tracer, fn, args, kwargs)
    held = {id(_local(t).untyped_storage()) for t in given}
    outs = [t for t in _arg_tensors((out,), {})
            if id(_local(t).untyped_storage()) not in held]
    mem = ProgramMemory(arg_bytes=_storage_bytes(given),
                        out_bytes=_storage_bytes(outs),
                        temp_bytes=int(tracer.peak))
    return tracer.cost, mem, out


def analyze_program(fn, *args, **kwargs) -> HloCost:
    """The reference's ``analyze_hlo`` for a program of the port: ``fn``
    run once on meta tensors, each dispatched operation counted."""
    return trace_program(fn, *args, **kwargs)[0]


def top_contributors(fn, *args, metric: str = "bytes", k: int = 20,
                     **kwargs):
    """Per-operation attribution of bytes, product flops or collective
    result bytes (``metric`` "bytes", "flops" or "collective"), the dry
    run's profile: rows of (value, module, op, result type, aten
    overload) sorted by value, the module the qualified name of the
    ``nn.Module`` that issued the op (``<…Backward0>``, autograd's node,
    for an op the backward pass issues outside any recomputed forward).
    The module takes the place of the reference's computation and
    op_name.  A program of plain tensors (one device) has no collective
    rows."""
    rows: list = []
    _run(_Tracer(rows), fn, args, kwargs)
    key = metric if metric in ("flops", "collective") else "bytes"
    out = [(r[key], r["module"], r["op"], r["type"], r["overload"])
           for r in rows if r[key]]
    out.sort(key=lambda r: r[0], reverse=True)
    return out[:k]
