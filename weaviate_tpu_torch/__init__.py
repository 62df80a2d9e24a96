"""weaviate_tpu_torch: the PyTorch/CUDA port of weaviate_tpu.

It keeps the JAX package's module paths and class names (``ops/``,
``engine/``, ``runtime/``, ``db/`` ...) and runs its hot path through
CUDA kernels written for Hopper (``csrc/``). It imports neither ``jax``
nor anything of ``weaviate_tpu``. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

from weaviate_tpu_torch.device import DEFAULT_DEVICE, resolve

__version__ = "0.1.0"

__all__ = ["DEFAULT_DEVICE", "resolve"]
