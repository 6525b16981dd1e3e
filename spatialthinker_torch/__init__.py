"""SpatialThinker on PyTorch and CUDA (one NVIDIA H100).

The port of ``spatialthinker_tpu`` (JAX/Pallas), package beside package,
module names mirrored. It imports ``torch`` and never ``jax``; of the JAX
package it uses only the framework-free modules (``core``, ``eval``'s
``Provider`` base, ``utils.synthetic_tokenizer``, ``rewards``). Every TPU
kernel on a ported path is a hand-written Hopper kernel under ``csrc/``,
with its plain PyTorch version beside it in ``ops/``.
"""

__version__ = "0.1.0"
