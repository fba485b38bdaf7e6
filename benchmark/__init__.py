"""The port's benchmark: see ``run.py`` and ``harness.py``."""
