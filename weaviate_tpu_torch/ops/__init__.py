"""Device ops: distances, top-k selection and the CUDA kernels."""

from weaviate_tpu_torch.ops.distances import (
    DISTANCE_METRICS,
    MASKED_DISTANCE,
    normalize,
    pairwise_distance,
    single_distance,
)
from weaviate_tpu_torch.ops.topk import (
    chunked_topk,
    chunked_topk_distances,
    merge_topk,
    topk_smallest,
)

__all__ = [
    "DISTANCE_METRICS",
    "MASKED_DISTANCE",
    "normalize",
    "pairwise_distance",
    "single_distance",
    "chunked_topk",
    "chunked_topk_distances",
    "merge_topk",
    "topk_smallest",
]
