"""Certified degradation ladder: never execute an infeasible allocation.

``DegradingPolicy`` wraps an ordered tuple of policies ("rungs") behind
the standard policy interface.  Every event it evaluates each rung and
selects, per workload, the **first** whose certificate
(``robust.certificates.allocation_ok`` — finite, non-negative,
Σθ ≤ B(t)) passes; a workload on which every rung fails gets the
all-zero allocation (trivially feasible; the engine then simply advances
to the next arrival/fault event).  The canonical ladder
(``DegradingPolicy.ladder``) is

    SmartFill  →  GWF-static  →  EQUI

i.e. optimal re-planning, then weighted water-filling without the
carried CDR constants, then an even split — strictly decreasing solver
complexity, so whatever poisoned the expensive rung (a non-converged μ*
descent, a NaN'd carry, a hostile budget) is progressively less able to
poison the fallback.

Selection is branchless (``torch.where`` over rung outputs, one
certificate a lane), so one workload's fault never moves another, and
the wrapper is **bit-identical** to the primary rung wherever the
primary's certificate passes: ``where(True, θ_primary, ·)`` is the
untouched primary allocation ("certificates are free when healthy").
The cost is evaluating the lower rungs eagerly at every event; keep them
cheap (one CAP solve and two ops above) next to a primary that runs a
full SmartFill re-plan.

``SaboteurPolicy`` is the matching chaos tool: it wraps any rung and
corrupts its output on demand (NaN, overspend, negative) so tests and
the chip run can force certificate failures without relying on a real
solver divergence.
"""
from __future__ import annotations

import dataclasses

import torch

from .._device import as_tensor, resolve_device
from ..sched.policies import (EquiPolicy, GWFStaticPolicy, Policy,
                              SmartFillPolicy)
from .certificates import allocation_ok

__all__ = ["DegradingPolicy", "SaboteurPolicy", "degradation_report",
           "ladder_plan_table"]


@dataclasses.dataclass(frozen=True)
class DegradingPolicy(Policy):
    """Certificate-gated fallback chain over ``rungs`` (most- to
    least-capable).  See the module docstring for semantics.

    The rungs are nested leaves: ``bind`` binds every rung, and
    per-workload rung parameters (e.g. (K,)-shaped budgets) batch
    through ``simulate_ensemble`` like any other policy leaf.  ``tol``
    is the certificate tolerance.
    """

    rungs: tuple
    tol: float = 1e-6
    name = "Degrading"
    LEAVES = ("rungs",)

    def __post_init__(self):
        if not self.rungs:
            raise ValueError("DegradingPolicy needs at least one rung")
        object.__setattr__(self, "rungs", tuple(self.rungs))

    @property
    def B(self):
        """The primary rung's budget (the ladder shares one server)."""
        return self.rungs[0].B

    @classmethod
    def ladder(cls, sp, B: float | None = None, primary: Policy | None = None,
               tol: float = 1e-6) -> "DegradingPolicy":
        """The canonical SmartFill → GWF-static → EQUI ladder.

        ``primary`` overrides the first rung (e.g. a pinned
        ``HeteroSmartFillPolicy``); the fallback rungs are always built
        on the *shared* speedup ``sp`` and budget ``B``.
        """
        B = float(sp.B if B is None else B)
        primary = SmartFillPolicy(sp, B=B) if primary is None else primary
        return cls(rungs=(primary, GWFStaticPolicy(sp, B=B),
                          EquiPolicy(B=B)), tol=tol)

    def _certified(self, rem, w, active, b, moved):
        """Rung outputs and their (K,) certificates under the live
        budget.  Without a moved budget every rung spends its own B, as
        the engine's unfaulted call does."""
        outs, oks = [], []
        for rung in self.rungs:
            th = torch.where(active, rung(rem, w, active, b if moved else None),
                             0.0)
            outs.append(th)
            oks.append(allocation_ok(th, b, active, self.tol))
        return outs, oks

    def _select(self, rem, w, active, b, moved):
        """(allocation, rung index) per workload."""
        outs, oks = self._certified(rem, w, active, b, moved)
        # fold from the bottom: zero floor, then each higher rung takes
        # precedence where certified — where(True, θ_primary, ·) keeps
        # a healthy lane bit-identical to the unwrapped primary
        out = torch.zeros_like(outs[0])
        idx = torch.full(oks[0].shape, len(self.rungs), dtype=torch.int32,
                         device=rem.device)
        for i in reversed(range(len(outs))):
            out = torch.where(oks[i][:, None], outs[i], out)
            idx = torch.where(oks[i], i, idx)
        return out, idx

    def _allocate(self, rem, w, active, b, moved):
        return self._select(rem, w, active, b, moved)[0]

    def rung_index(self, rem, w, active, B=None):
        """Which rung fired, per workload: 0 = primary, …, len(rungs) =
        all failed (zero allocation).  Diagnostic; (K,) int32 for a
        (K, M) state, 0-dim for one workload."""
        rem, w, active, b, one = self._state(rem, w, active, B)
        idx = self._select(rem, w, active, b, B is not None)[1]
        return idx[0] if one else idx


@dataclasses.dataclass(frozen=True)
class SaboteurPolicy(Policy):
    """Chaos wrapper: corrupt ``inner``'s allocation to force a
    certificate failure.

    mode:
      * ``"nan"``       — NaN on every active slot (non-finite θ).
      * ``"overspend"`` — 2·B to every active job (Σθ > B).
      * ``"negative"``  — the negated allocation minus 1 (θ < 0).

    ``min_active`` only sabotages workloads with more than that many
    active jobs (per lane), so a run is poisoned mid-way and finishes
    healthy (mixed-rung trajectories).
    """

    inner: Policy
    mode: str = "nan"
    min_active: int = 0
    name = "Saboteur"
    LEAVES = ("inner",)
    MODES = ("nan", "overspend", "negative")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}")

    @property
    def B(self):
        return self.inner.B

    def _allocate(self, rem, w, active, b, moved):
        th = self.inner(rem, w, active, b if moved else None)
        if self.mode == "nan":
            bad = torch.where(active, torch.full_like(rem, torch.nan), 0.0)
        elif self.mode == "overspend":
            bad = torch.where(active, 2.0 * b[:, None], 0.0)
        else:
            bad = torch.where(active, -th - 1.0, 0.0)
        hit = active.sum(-1) > self.min_active
        return torch.where(hit[:, None], bad, th)


def ladder_plan_table(policy: Policy, rem, w, B=None, device=None):
    """(M, M) allocation table from a per-event policy, for plan-table
    executors.

    Column m−1 holds ``policy``'s allocation for the m-row prefix of the
    (row-coordinate) state ``rem``/``w`` — the same column-by-active-
    count layout as a SmartFill Θ table, built from one policy call with
    the M prefixes as M lanes.  Built from a ``DegradingPolicy`` ladder,
    every column is certificate-gated (worst case all-zero, which merely
    idles the window).  Any per-event policy works; job-indexed (M,)
    leaves are given to every lane.  Runs on ``device``, else on
    ``rem``'s or the policy's device, else CUDA.
    """
    dev = resolve_device(device, rem, *policy._tensor_leaves())
    rem = as_tensor(rem, dev)
    if not rem.is_floating_point():
        rem = rem.double()
    w = as_tensor(w, dev, rem.dtype)
    M = rem.shape[0]
    pol = policy.bind(dev, rem.dtype).map_leaves(
        lambda l: l.expand(M, M) if l.ndim == 1 and l.shape[0] == M else l)
    idx = torch.arange(M, device=dev)
    act = idx[None, :] <= idx[:, None]          # lane m−1: the m-row prefix
    th = pol(rem.expand(M, M).clone(), w.expand(M, M).clone(), act, B)
    return torch.where(act, th, 0.0).T


def degradation_report(sp, x, w, policy: DegradingPolicy, B=None,
                       arrival=None, faults=None, rtol: float = 1e-12,
                       device=None):
    """Replay one instance through the host oracle, recording which
    rung fired when.

    Runs ``simulate_policy_reference`` with a recording wrapper around
    ``policy`` (evaluated on ``device``, else on the device of ``sp``'s
    leaves, in float64) and returns ``{"J", "T", "rung_counts",
    "n_events"}`` where rung_counts maps rung index → event count (index
    ``len(rungs)`` = every certificate failed, zero allocation).  Host
    diagnostics only — the hot path never pays for this.
    """
    from ..core.simulator import simulate_policy_reference

    dev = resolve_device(device, sp)
    pol = policy.bind(dev, torch.float64)
    counts: dict[int, int] = {}

    def recording(rem, w_, active, Bt=None):
        st = pol._state(rem, w_, active, Bt)
        th, idx = pol._select(*st[:4], Bt is not None)
        i = int(idx[0])
        counts[i] = counts.get(i, 0) + 1
        return th[0].cpu().numpy()

    res = simulate_policy_reference(sp, x, w, recording, B=B,
                                    arrival=arrival, rtol=rtol,
                                    faults=faults)
    return {"J": res.J, "T": res.T, "rung_counts": counts,
            "n_events": res.n_events}
