from .engine import ServeEngine, make_prefill, make_serve_step  # noqa: F401
