"""Core algorithms: speedup families, GWF, SmartFill, heSRPT, CDR
verification and the host reference simulator."""
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
    stack_speedups,
    take_job,
)
from .gwf import (  # noqa: F401
    HeteroPrep,
    cap_bracket_probe,
    cap_residual,
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
    SmartFillSchedule,
    completion_times,
    objective,
    smartfill,
    smartfill_allocations,
)
from .batch import (  # noqa: F401
    BatchedSmartFillSchedule,
    current_allocations_from,
    smartfill_allocations_batched,
    smartfill_batched,
)
from .hesrpt import fit_power, hesrpt_allocations, hesrpt_policy  # noqa: F401
from .cdr import cdr_violation, estimate_constants  # noqa: F401
from .simulator import (  # noqa: F401
    SimResult,
    n_events_for,
    simulate_policy,
    simulate_policy_reference,
)
