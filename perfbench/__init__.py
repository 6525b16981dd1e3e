"""The benchmark of the PyTorch and CUDA port (``spatialthinker_torch``): see
``run.py``, and ``BENCHMARK.json`` at the root of the repository."""
