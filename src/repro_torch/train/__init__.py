"""Training: AdamW, the train step and loop, checkpoints and the
fault-tolerance hooks (the JAX package's ``train/`` on tensors)."""
from .optim import (  # noqa: F401
    AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_schedule)
from .loop import TrainState, make_train_step, train_loop  # noqa: F401
from . import checkpoint  # noqa: F401
from .fault_tolerance import (  # noqa: F401
    CheckpointHook, HeartbeatMonitor, RetryableStep)
