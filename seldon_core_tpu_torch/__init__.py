"""seldon-core-tpu on PyTorch and CUDA: the port of ``seldon_core_tpu`` to an
NVIDIA H100. It imports ``torch`` and never ``jax`` or ``seldon_core_tpu``;
module paths mirror the JAX package's."""

__version__ = "0.1.0"
