"""Fault-tolerance layer for the scheduling stack.

Three independently usable layers:

  * dynamic budgets + fault injection — ``core.simulator.FaultTrace``
    executed by the fault-aware engine, sampled by
    ``core.workloads.sample_fault_traces`` (re-exported here);
  * plan certificates + the degradation ladder —
    ``certificates.allocation_ok`` / ``certificates.certify_plan`` and
    ``degrade.DegradingPolicy`` (SmartFill → GWF-static → EQUI);
  * the host watchdog — ``watchdog.Watchdog`` retry/timeout/backoff for
    the serving control loop.
"""
from ..core.simulator import (  # noqa: F401
    KIND_BUDGET,
    KIND_FAILURE,
    KIND_STRAGGLER,
    FaultTrace,
    budget_trace,
)
from ..core.workloads import sample_fault_traces  # noqa: F401

from .certificates import PlanCertificate, allocation_ok, certify_plan  # noqa: F401
from .degrade import (DegradingPolicy, SaboteurPolicy,  # noqa: F401
                      degradation_report, ladder_plan_table)
from .watchdog import Watchdog, WatchdogGiveUp  # noqa: F401

__all__ = [
    "KIND_BUDGET",
    "KIND_FAILURE",
    "KIND_STRAGGLER",
    "FaultTrace",
    "budget_trace",
    "sample_fault_traces",
    "PlanCertificate",
    "allocation_ok",
    "certify_plan",
    "DegradingPolicy",
    "SaboteurPolicy",
    "degradation_report",
    "ladder_plan_table",
    "Watchdog",
    "WatchdogGiveUp",
]
