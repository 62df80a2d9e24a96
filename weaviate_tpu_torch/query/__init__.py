"""Query-feature layer (port of ``weaviate_tpu/query``): aggregations,
sorting and autocut.

Reference: adapters/repos/db/aggregator/, adapters/repos/db/sorter/,
entities/autocut/.
"""

from weaviate_tpu_torch.query.aggregator import (PropertyAggregator,
                                                 aggregate_objects,
                                                 combine_partials)
from weaviate_tpu_torch.query.autocut import autocut, autocut_results
from weaviate_tpu_torch.query.sorter import sort_objects

__all__ = [
    "PropertyAggregator",
    "aggregate_objects",
    "combine_partials",
    "autocut",
    "autocut_results",
    "sort_objects",
]
