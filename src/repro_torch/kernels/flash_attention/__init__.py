"""Flash attention (K5): see ``kernel.py``, ``ops.py`` and ``ref.py``."""
