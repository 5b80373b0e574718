"""Scheduling policies for the scenario engine (``core/simulator.py``) and
the cluster scheduler (``cluster.py``)."""
from .cluster import (  # noqa: F401
    ClusterScheduler,
    ClusterSimResult,
    Job,
    integerize,
)
from .policies import (  # noqa: F401
    ClassSmartFillPolicy,
    EquiPolicy,
    GWFStaticPolicy,
    HeSRPTPolicy,
    HeteroSmartFillPolicy,
    Policy,
    SRPT1Policy,
    SmartFillPolicy,
    WeightedMarginalRatePolicy,
    default_zoo,
)
from .elastic import ElasticTrainer, ReallocEvent, mesh_for_chips  # noqa: F401
