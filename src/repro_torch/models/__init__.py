"""The serving model stack of the port (see ``transformer.py``)."""
from .transformer import (  # noqa: F401
    Transformer,
    decode_step,
    init_decode_state,
    init_params,
    prefill,
)
