"""Linear recurrence scan (K4): see ``kernel.py``, ``ops.py`` and ``ref.py``."""
