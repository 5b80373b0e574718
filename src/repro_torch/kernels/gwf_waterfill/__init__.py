"""Water-filling kernels: see ``kernel.py``, ``ops.py`` and ``ref.py``."""
