from .engine import ServeEngine, make_prefill, make_serve_step  # noqa: F401
from .admission import AdmissionController, AdmissionDecision  # noqa: F401
from .stream import (PlanBuffer, StreamCascadePolicy,  # noqa: F401
                     StreamController, StreamMetrics, StreamResult)
