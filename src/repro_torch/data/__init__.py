"""The training data pipeline of the port (numpy; see ``pipeline.py``)."""
from .pipeline import (  # noqa: F401
    SyntheticTokens, TokenFile, host_batch_iterator, make_batch_specs)
