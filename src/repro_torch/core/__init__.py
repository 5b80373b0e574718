"""Core algorithms: speedup families, GWF, SmartFill (shared and per-job
speedups), heSRPT, CDR verification, the seeded workload sampler and the
host reference simulator."""
from .speedup import (  # noqa: F401
    GenericSpeedup,
    RegularSpeedup,
    Speedup,
    StackedSpeedup,
    broadcast_speedup,
    collapse_homogeneous,
    from_roofline,
    inner_per_job,
    is_per_job,
    log_speedup,
    neg_power,
    power,
    rowwise,
    saturating,
    shifted_power,
    stack_speedup_rows,
    stack_speedups,
    take_job,
)
from .gwf import (  # noqa: F401
    HeteroPrep,
    auto_impl,
    cap_bracket_probe,
    cap_residual,
    hetero_approx,
    hetero_breakpoints_init,
    hetero_breakpoints_insert,
    hetero_prepare,
    hetero_solve,
    solve_cap,
    solve_cap_batched,
    solve_cap_generic,
    solve_cap_hetero,
    solve_cap_hetero_sorted,
    solve_cap_regular,
    solve_cap_regular_reference,
    waterfill_level,
    waterfill_prepare,
    waterfill_solve,
)
from .smartfill import (  # noqa: F401
    HeteroSmartFillSchedule,
    SmartFillSchedule,
    WarmStart,
    completion_times,
    normalized_order,
    objective,
    smartfill,
    smartfill_allocations,
    smartfill_hetero,
    smartfill_hetero_reference,
    smartfill_reference,
    smartfill_warm,
)
from .batch import (  # noqa: F401
    BatchedSmartFillSchedule,
    current_allocations_from,
    hetero_order_batch,
    smartfill_allocations_batched,
    smartfill_batched,
    smartfill_hetero_batched,
)
from .hesrpt import fit_power, hesrpt_allocations, hesrpt_policy  # noqa: F401
from .cdr import cdr_violation, estimate_constants  # noqa: F401
from .workloads import FAMILIES, WorkloadBatch, sample_workloads  # noqa: F401
from .simulator import (  # noqa: F401
    SimResult,
    n_events_for,
    simulate_policy,
    simulate_policy_reference,
)
