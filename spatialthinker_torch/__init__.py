"""SpatialThinker on PyTorch and CUDA (one NVIDIA H100).

The port of ``spatialthinker_tpu`` (JAX/Pallas), package beside package,
module names mirrored. It imports ``torch``, never ``jax`` and nothing
of the JAX package: what it needs of that package's framework-free modules
(``core``, ``rewards``, ``utils``, the data helpers, the ``Provider`` base) it
keeps as its own copy. Every TPU
kernel on a ported path is a hand-written Hopper kernel under ``csrc/``,
with its plain PyTorch version beside it in ``ops/``.
"""

__version__ = "0.1.0"
