"""Query-feature layer (port of ``weaviate_tpu/query``): autocut, which
nearVector, bm25 and hybrid take. Aggregation and sorting are a later
slice of the port.

Reference: entities/autocut/.
"""

from weaviate_tpu_torch.query.autocut import autocut, autocut_results

__all__ = ["autocut", "autocut_results"]
