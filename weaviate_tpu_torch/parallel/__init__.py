"""Multi-device parallelism (port of ``weaviate_tpu/parallel``).

The port serves one card. Only ``host_count`` exists, for the node
status routes; row shards over ``torch.distributed`` are ROADMAP Queue 1
item 6.
"""

from weaviate_tpu_torch.parallel.mesh import (host_count,
                                              require_single_device)

__all__ = ["host_count", "require_single_device"]
