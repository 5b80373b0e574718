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
               scatters, sort, and reductions
  collectives  zero: one process drives one device (D = 1), so the
               program holds none

The reference expands each while loop by its trip count; here a Python
loop runs its body once an iteration, so each iteration is counted as
it runs (``while_trips`` stays empty).  ``trace_program`` also tracks
the bytes of every storage an operation allocates, from the operation
to its release: the peak of those live intermediates is the
counterpart of XLA's temp size.

Every tensor the program is given must be on meta, and so must every
operand the mode sees: the port's CUDA kernels are ``ctypes`` calls that
the dispatcher never sees (``kernels/_build.py``), so a count on the
card would leave K4 and K5 out.  On meta, ``flash_attention_op`` and
``linear_scan_op`` take their plain versions by their device rule;
those count the whole S × T score product, as the XLA attention the
reference's dry run lowers does.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import Counter

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["analyze_program", "HloCost", "ProgramMemory", "top_contributors",
           "trace_program"]

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
         "_unsafe_view"}


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


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _op_cost(func, args, kwargs, out):
    """(flops, transcendentals, bytes, bytes_fused, product flops) of one
    dispatched operation."""
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") else name
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if func.is_view or base in _FREE or not outs:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    relems = sum(t.numel() for t in outs)
    rbytes = sum(_nbytes(t) for t in outs)
    flops = trans = prod = 0.0
    if base in _PRODUCTS:
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
                       or base in _SORTS or base in _REDUCTIONS) else 0.0
    return float(flops), float(trans), nbytes, fused, prod


_AUTOGRAD = "torch/autograd/"


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
        ins = _tensors((args, kwargs))
        for t in ins:
            if t.device.type != "meta":
                raise ValueError(
                    f"{func} got a tensor on {t.device}: the count runs on "
                    f"meta tensors only (a CUDA kernel's launch is a ctypes "
                    f"call the dispatcher never sees)")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        flops, trans, nbytes, fused, prod = _op_cost(func, args, kwargs, out)
        c = self.cost
        c.flops += flops
        c.transcendentals += trans
        c.bytes += nbytes
        c.bytes_fused += fused
        if not func.is_view:
            self._track(outs, ins)
        if self.rows is not None and (nbytes or flops):
            shape = ",".join(f"{str(t.dtype)[6:]}{list(t.shape)}"
                             for t in outs)
            self.rows.append({"bytes": nbytes, "flops": prod,
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
    held = {id(t.untyped_storage()) for t in given}
    outs = [t for t in _arg_tensors((out,), {})
            if id(t.untyped_storage()) not in held]
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
    """Per-operation attribution of bytes or product flops (``metric``
    "bytes" or "flops"; "collective" gives no rows at D = 1), the dry
    run's profile: rows of (value, module, op, result type, aten
    overload) sorted by value, the module the qualified name of the
    ``nn.Module`` that issued the op (``<…Backward0>``, autograd's node,
    for an op the backward pass issues outside any recomputed forward).
    The module takes the place of the reference's computation and
    op_name."""
    rows: list = []
    _run(_Tracer(rows), fn, args, kwargs)
    if metric == "collective":
        return []
    key = "flops" if metric == "flops" else "bytes"
    out = [(r[key], r["module"], r["op"], r["type"], r["overload"])
           for r in rows if r[key]]
    out.sort(key=lambda r: r[0], reverse=True)
    return out[:k]
