"""Filter trees -> AllowList masks (copied from the JAX package)."""

from weaviate_tpu_torch.filters.filters import Filter, Operator, compute_allow_mask

__all__ = ["Filter", "Operator", "compute_allow_mask"]
