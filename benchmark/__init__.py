"""The benchmark of the PyTorch and CUDA port (``medvill_torch``): see
``run.py`` and ``harness.py``."""
