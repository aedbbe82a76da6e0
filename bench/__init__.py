"""The serving benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` is the entry point. Everything that belongs to one model
configuration, one traffic mix, one per-layer metric or one reference
model family is a file of its own, found by its name (``manifest``)."""
