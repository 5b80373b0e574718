"""The model stack of the port: serving and the training forward (see
``transformer.py``)."""
from .transformer import (  # noqa: F401
    Transformer,
    decode_step,
    init_decode_state,
    init_params,
    model_apply,
    prefill,
)
