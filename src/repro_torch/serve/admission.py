"""Admission control for the serving tier via batched SmartFill planning.

A serving frontend holds R running jobs and a queue of C admission
candidates.  Whether admitting candidate c is worth it is a *scheduling*
question: how much does the optimal weighted completion time J of the
mix increase when c joins?  That marginal cost is exactly what SmartFill
computes — and with the batched planner the baseline instance plus all C
candidate mixes are solved in **one** batched call, so admission
decisions cost one planning round-trip regardless of queue depth.

Instances are padded to R+1 slots with the batched API's prefix-mask
convention (see ``core/batch.py``): instance 0 is the running set alone,
instance 1+i is the running set plus candidate i, each sorted
sizes-non-increasing / weights-non-decreasing.

Two marginal-cost estimators (``estimator=``):

  * ``"plan"`` (default) — the batched SmartFill planner's J.
  * ``"simulate"`` — execute SmartFill on every mix through the scenario
    engine (one ``simulate_ensemble`` call); identical ΔJ by time
    consistency, and the place where execution-side cost models
    (reallocation, preemption) can enter the score.  When a 1-D fleet
    mesh is active (or passed as ``mesh=``), the candidate mixes shard
    across it via ``simulate_ensemble_sharded``.

Mixed-model admission (paper §7): running jobs and candidates may each
carry their *own* regular speedup (``running_speedups`` /
``cand_speedups`` — e.g. the ten roofline-calibrated shapes of
``sched/speedup_models.py``).  Mixes are then ranked by normalized size
(size / sᵢ(B)), the per-job parameters ride along as (C+1, M) stacked
speedup leaves, and ΔJ comes from the per-job SmartFill solver.

The controller runs on the device of its speedup's leaves (a CUDA
speedup by default) and returns numpy decisions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import smartfill_batched
from ..core.speedup import RegularSpeedup, Speedup

__all__ = ["AdmissionDecision", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one batched admission evaluation.

    admit: (C,) bool — marginal cost under the threshold.
    marginal_cost: (C,) ΔJ of adding each candidate to the running set.
    baseline_J: optimal J of the running set alone.
    status: "ok", or "degraded: …" when the watchdog exhausted its
      retries and the controller fell back to deny-all (admit all-False,
      marginal_cost +inf) instead of crashing the serving loop.
    """

    admit: np.ndarray
    marginal_cost: np.ndarray
    baseline_J: float
    status: str = "ok"

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _sorted_instance(sizes, weights):
    order = np.lexsort((weights, -sizes))
    return sizes[order], weights[order]


def _host(v) -> np.ndarray:
    """A score vector (tensor or array) as float64 numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64)


class AdmissionController:
    """Scores admission candidates with one batched SmartFill call.

    Args:
      sp: server speedup function (its leaves' device is where the
        controller plans).
      B: bandwidth budget (defaults to sp.B).
      cost_threshold: admit a candidate iff its marginal ΔJ is at most
        this (np.inf admits everything — the decision is then purely a
        ranking, via ``AdmissionDecision.marginal_cost``).
      mesh: optional 1-D ``FleetMesh`` for the ``"simulate"`` estimator —
        candidate mixes shard across it.  Defaults to the active mesh
        context at evaluation time (one device when none is active).
      watchdog: optional ``robust.Watchdog``.  When set, the J-scoring
        call runs under it (retry/timeout/backoff, results validated
        all-finite); if the watchdog gives up the controller returns a
        deny-all ``AdmissionDecision`` with ``status="degraded: …"``
        instead of crashing the serving loop.
      agreeable: ``"require"`` (default) rejects non-agreeable
        shared-function mixes with ValueError — SmartFill's J is only
        the optimum on agreeable instances, so ΔJ would mis-rank
        candidates.  ``"rank"`` accepts them and scores the SJF-by-size
        ranking's J instead: the live-state mode a streaming controller
        needs, where admission scores candidates against *partially
        served* running jobs (shrunk sizes under their admission-time
        weights are naturally non-agreeable) and the executed schedule
        is exactly that SJF ranking.
    """

    def __init__(self, sp: Speedup, B: float | None = None,
                 cost_threshold: float = np.inf, estimator: str = "plan",
                 mesh=None, watchdog=None, agreeable: str = "require"):
        if estimator not in ("plan", "simulate"):
            raise ValueError("estimator must be 'plan' or 'simulate'")
        if agreeable not in ("require", "rank"):
            raise ValueError("agreeable must be 'require' or 'rank'")
        self.sp = sp
        self.B = float(sp.B if B is None else B)
        self.cost_threshold = float(cost_threshold)
        self.estimator = estimator
        self.mesh = mesh
        self.watchdog = watchdog
        self.agreeable = agreeable

    def evaluate(self, running_sizes, running_weights,
                 cand_sizes, cand_weights,
                 running_speedups=None,
                 cand_speedups=None) -> AdmissionDecision:
        """Marginal planning cost of each candidate, one batched call.

        running_*: (R,) the currently admitted jobs (any order).
        cand_*: (C,) the admission candidates.
        running_speedups / cand_speedups: optional per-job regular
          speedups (lists; a None entry means the controller's shared
          function).  Providing either switches to mixed-model scoring:
          mixes rank by normalized size and solve on the per-job
          SmartFill path.

        In the shared-function mode every running+candidate mix must be
        *agreeable*: sorted by size descending, weights are
        non-decreasing (slowdown weights w = 1/x always are).
        Non-agreeable mixes raise ValueError unless ``agreeable="rank"``.
        """
        rs = np.asarray(running_sizes, dtype=np.float64)
        rw = np.asarray(running_weights, dtype=np.float64)
        cs = np.asarray(cand_sizes, dtype=np.float64)
        cw = np.asarray(cand_weights, dtype=np.float64)
        R, C = rs.shape[0], cs.shape[0]
        hetero = running_speedups is not None or cand_speedups is not None
        if C == 0:
            if hetero and R > 0:
                # keep the baseline consistent with the J[0] a C > 0
                # call reports for the identical running set
                X, W, act, spH = self._hetero_instances(
                    rs, rw, cs, cw, running_speedups, cand_speedups)
                sched = smartfill_batched(spH, X, W, B=self.B, active=act)
                baseline = float(_host(sched.J)[0])
            else:
                baseline = self._baseline_J(rs, rw)
            return AdmissionDecision(
                admit=np.zeros(0, dtype=bool),
                marginal_cost=np.zeros(0),
                baseline_J=baseline)

        if hetero:
            X, W, act, sp = self._hetero_instances(
                rs, rw, cs, cw, running_speedups, cand_speedups)
        else:
            sp = self.sp
            M = R + 1
            X = np.zeros((C + 1, M))
            W = np.zeros((C + 1, M))
            act = np.zeros((C + 1, M), dtype=bool)
            X[0, :R], W[0, :R] = _sorted_instance(rs, rw)
            act[0, :R] = True
            for i in range(C):
                xs = np.concatenate([rs, cs[i: i + 1]])
                ws = np.concatenate([rw, cw[i: i + 1]])
                X[1 + i], W[1 + i] = _sorted_instance(xs, ws)
                act[1 + i] = True
            # SmartFill's optimality (and hence the ΔJ ranking) needs
            # agreeable instances; 'rank' mode knowingly scores the SJF
            # ranking's J instead (see the constructor docstring)
            if self.agreeable == "require":
                self._validate_agreeable(X, W, act)

        def score():
            if self.estimator == "simulate":
                return self._simulated_J(X, W, sp)
            # no validate= here: shared-function mixes were checked above
            # (when required), and mixed-model rows are ordered by
            # *normalized* size, where raw-size monotonicity need not hold
            sched = smartfill_batched(sp, X, W, B=self.B, active=act)
            return _host(sched.J)

        if self.watchdog is not None:
            from ..robust.watchdog import WatchdogGiveUp

            try:
                J = self.watchdog.call(
                    score, label=f"admission score ({self.estimator})",
                    validate=lambda j: bool(np.all(np.isfinite(j))))
            except WatchdogGiveUp as e:
                # fail closed: admit nothing rather than admit on garbage
                return AdmissionDecision(
                    admit=np.zeros(C, dtype=bool),
                    marginal_cost=np.full(C, np.inf),
                    baseline_J=float("nan"),
                    status=f"degraded: {e}")
        else:
            J = score()
        marginal = J[1:] - J[0]
        return AdmissionDecision(
            admit=marginal <= self.cost_threshold,
            marginal_cost=marginal,
            baseline_J=float(J[0]),
        )

    def _hetero_instances(self, rs, rw, cs, cw, run_sps, cand_sps):
        """Padded mixed-model instances + (C+1, M) stacked speedup leaves.

        Instance 0 = running set; 1+i = running ∪ candidate i.  Each mix
        is ranked by normalized size under each job's own s (ties by
        weight); padded slots edge-replicate the last live job's family
        parameters (``core.speedup.stack_speedup_rows``), so every padded
        row stays a valid family member.  The controller's shared
        function only enters as the default of jobs whose list entry is
        None.
        """
        from ..core import normalized_order
        from ..core.speedup import stack_speedup_rows, stack_speedups

        R, C = rs.shape[0], cs.shape[0]
        M = R + 1

        def member(sp, what, i):
            sp = self.sp if sp is None else sp
            if not isinstance(sp, RegularSpeedup):
                raise TypeError(
                    f"{what} {i}: {type(sp).__name__} cannot join a "
                    "mixed-model admission batch — per-job scoring needs "
                    "regular-family speedups (fit one with "
                    "core.hesrpt.fit_power)")
            return sp

        run_sps = list(run_sps) if run_sps is not None else [None] * R
        cand_sps = list(cand_sps) if cand_sps is not None else [None] * C
        if len(run_sps) != R or len(cand_sps) != C:
            raise ValueError("speedup lists must match the job counts")
        run_sps = [member(s, "running job", i)
                   for i, s in enumerate(run_sps)]
        cand_sps = [member(s, "candidate", i)
                    for i, s in enumerate(cand_sps)]

        X = np.zeros((C + 1, M))
        W = np.zeros((C + 1, M))
        act = np.zeros((C + 1, M), dtype=bool)
        rows = []
        for inst in range(C + 1):
            if inst == 0:
                xs, ws, sps = rs, rw, run_sps
            else:
                i = inst - 1
                xs = np.concatenate([rs, cs[i: i + 1]])
                ws = np.concatenate([rw, cw[i: i + 1]])
                sps = run_sps + [cand_sps[i]]
            k = xs.shape[0]
            if k == 0:
                rows.append([])
                continue
            order = normalized_order(
                stack_speedups(sps, B=self.B), xs, ws, self.B)
            X[inst, :k] = xs[order]
            W[inst, :k] = ws[order]
            act[inst, :k] = True
            rows.append([sps[oi] for oi in order])
        return X, W, act, stack_speedup_rows(rows, M, self.B,
                                             device=self.sp.device)

    @staticmethod
    def _validate_agreeable(X, W, act):
        from ..core.batch import validate_padded_instances

        try:
            validate_padded_instances(X, W, act.sum(axis=1))
        except ValueError as e:
            raise ValueError(
                "admission instances must be agreeable (larger size ⇒ "
                f"smaller-or-equal weight, e.g. w = 1/x): {e}") from e

    def _simulated_J(self, X, W, sp=None) -> np.ndarray:
        """Score mixes by *executing* SmartFill on the scenario engine.

        One ``simulate_ensemble`` call over the C+1 padded instances — an
        independent event-driven estimate of the same ΔJ the planner
        predicts (equal to ≤1e-6 by Prop. 7 / time consistency).  With a
        fleet mesh (``mesh=`` or an active 1-D mesh context) the
        instances shard across its devices through
        ``simulate_ensemble_sharded`` instead.  Mixed-model batches
        (per-job (C+1, M) speedup leaves) execute under the re-planning
        per-job SmartFill policy.
        """
        from ..core import simulate_ensemble
        from ..core.speedup import inner_per_job
        from ..distributed.fleet import (active_fleet_mesh,
                                         simulate_ensemble_sharded)
        from ..sched.policies import HeteroSmartFillPolicy, SmartFillPolicy

        sp = self.sp if sp is None else sp
        pol_cls = (HeteroSmartFillPolicy
                   if inner_per_job(sp, X.shape[0]) else SmartFillPolicy)
        policies = (pol_cls(sp, B=self.B),)
        mesh = self.mesh if self.mesh is not None else active_fleet_mesh()
        if mesh is not None:
            res = simulate_ensemble_sharded(sp, policies, X, W,
                                            B=self.B, mesh=mesh)
        else:
            res = simulate_ensemble(sp, policies, X, W, B=self.B)
        return _host(res.J[0])

    def _baseline_J(self, rs, rw) -> float:
        if rs.shape[0] == 0:
            return 0.0
        xs, ws = _sorted_instance(rs, rw)
        sched = smartfill_batched(self.sp, xs[None, :], ws[None, :],
                                  B=self.B,
                                  validate=self.agreeable == "require")
        return float(_host(sched.J)[0])

    def admit_best(self, running_sizes, running_weights,
                   cand_sizes, cand_weights, k: int = 1) -> np.ndarray:
        """Indices of the ≤ k admissible candidates with smallest ΔJ."""
        dec = self.evaluate(running_sizes, running_weights,
                            cand_sizes, cand_weights)
        order = np.argsort(dec.marginal_cost, kind="stable")
        return np.array([i for i in order if dec.admit[i]][:k], dtype=int)
