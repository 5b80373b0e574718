"""Scheduling policies for the scenario engine (``core/simulator.py``)."""
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
