"""Distributed layer: device meshes and the fleet-sharded planner,
ensemble runner and multi-tenant stream service.

The fleet layer re-exports lazily (PEP 562): it pulls in the whole core
solver/simulator stack, which a mesh-only consumer must not pay for.
"""
from .sharding import (  # noqa: F401
    LOGICAL_RULES,
    POLICIES,
    FleetMesh,
    PartitionSpec,
    active_mesh,
    constrain,
    logical_to_spec,
    param_sharding,
    set_mesh,
    state_sharding,
    with_logical_rules,
)

_FLEET_EXPORTS = ("FLEET_AXIS", "FleetStreamResult", "active_fleet_mesh",
                  "fleet_mesh", "plan_classes_sharded", "plan_sharded",
                  "serve_streams_sharded", "simulate_ensemble_sharded")


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from . import fleet
        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_FLEET_EXPORTS))
