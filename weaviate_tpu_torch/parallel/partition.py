"""Declarative partition rules: regex -> placement (port of
``weaviate_tpu/parallel/partition.py``).

The SPMD search entry points name their operands and a regex rule table
decides each one's placement, the JAX package's ``match_partition_rules``
pattern. Rule values are mesh-independent TEMPLATES: tuples whose entries
are ``None`` (replicated dim) or the ``ROWS`` token, which resolves to the
mesh's row axes (``'shard'`` on the 1-D mesh, ``('host', 'ici')`` on the
hierarchical one). A resolved placement is a plain tuple of those entries
(the JAX package's ``PartitionSpec``); templates may be shorter than the
array's rank, the trailing dims then replicated. ``row_spec`` is the
placement ``sharded_search.shard_array(..., dim=)`` gives.
"""

from __future__ import annotations

import re

import numpy as np

from weaviate_tpu_torch.parallel.mesh import (Mesh, host_count, n_row_shards,
                                              row_axes, shardable_capacity)

#: template token: resolves to the mesh's row-sharding axis/axes
ROWS = "@rows"

#: common templates
REPLICATED: tuple = ()
ROW_SHARDED = (ROWS,)          # leading dim = corpus rows / IVF lists
QUERY_MASK = (None, ROWS)      # [B, N] per-query masks: column-sharded,
#                                row-aligned with the corpus

#: operand placement for the flat SPMD scan (sharded_search.sharded_topk)
SEARCH_RULES = (
    (r"^(q|queries)$", REPLICATED),
    (r"^(x|corpus|vectors)$", ROW_SHARDED),
    (r"^(valid|x_sq_norms|sq_norms|norms)$", ROW_SHARDED),
    (r"^allow(_rows|_mask)?$", QUERY_MASK),
)

#: operand placement for the compressed SPMD scan (BQ / PQ / PQ4): the
#: codebook and packed query bits are replicated, codes + per-row state
#: row-shard, the optional bf16 rescore rows stay with their owning
#: device, per-query filter masks column-shard row-aligned
QUANTIZED_RULES = (
    (r"^(q|q_words)$", REPLICATED),
    (r"^(cent|centroids|codebook|pq_centroids)$", REPLICATED),
    (r"^(codes|rescore_rows)$", ROW_SHARDED),
    (r"^(valid|slots)$", ROW_SHARDED),
    (r"^allow(_rows|_mask)?$", QUERY_MASK),
)

#: operand placement for the IVF-PQ probe: EVERY list-dim array shards
#: over the list axis; only the query and the PQ codebook replicate
IVF_RULES = (
    (r"^q$", REPLICATED),
    (r"^pq_centroids$", REPLICATED),
    (r"^(centroids|list_codes|list_valid|list_slots|list_tvals)$",
     ROW_SHARDED),
)


def _is_scalar(arr) -> bool:
    shape = getattr(arr, "shape", None)
    if shape is None:
        return True
    return len(shape) == 0 or int(np.prod(shape)) == 1


def resolve_template(template, mesh: Mesh | None) -> tuple:
    """Template tuple -> concrete placement for ``mesh`` (``ROWS``
    entries become the mesh's row axes)."""
    axes = row_axes(mesh)
    return tuple(axes if entry == ROWS else entry for entry in template)


def match_partition_rules(rules, named_arrays: dict, mesh: Mesh | None):
    """``{name: array}`` -> ``{name: placement}`` by first-matching regex.
    Scalars (0-d or single-element) and absent operands (``None``) pass
    through replicated. A non-scalar operand no rule names is an error:
    silently replicating a corpus-sized array is the bug this table
    exists to prevent."""
    out = {}
    for name, arr in named_arrays.items():
        if arr is None or _is_scalar(arr):
            out[name] = resolve_template(REPLICATED, mesh)
            continue
        for pattern, template in rules:
            if re.search(pattern, name) is not None:
                out[name] = resolve_template(template, mesh)
                break
        else:
            raise ValueError(
                f"no partition rule matches operand {name!r} "
                f"(shape {getattr(arr, 'shape', None)}) — add it to the "
                "rule table in parallel/partition.py")
    return out


def row_spec(mesh: Mesh | None, dim: int = 0) -> tuple:
    """Rows sharded on ``dim``, every other dim replicated — the
    placement behind ``shard_array(..., dim=...)``."""
    return resolve_template((None,) * dim + (ROWS,), mesh)


def sharded_dim(placement: tuple) -> int | None:
    """The dim a resolved placement shards rows over, or None when it
    replicates."""
    for dim, entry in enumerate(placement):
        if entry is not None:
            return dim
    return None


def plan_corpus_placement(n_rows: int, dim: int, mesh: Mesh | None, *,
                          quantization: str = "bq",
                          chunk_size: int = 1024,
                          rescore_bytes_per_dim: int = 0) -> dict:
    """The placement plan for an ``n_rows x dim`` corpus on ``mesh``:
    shard-aligned capacity, bytes per component, and the per-host device
    load, WITHOUT allocating anything.

    ``quantization``: "bq" (packed sign bits, dim/32 u32 words/row),
    "pq4"/"pq" (one byte per segment, dim/4 segments assumed), or
    "none" (bf16 rows). ``rescore_bytes_per_dim`` adds owning-device
    bf16 rescore rows (2) when the serving path rescores on device."""
    n_shards = max(1, n_row_shards(mesh))
    n_hosts = max(1, host_count(mesh))
    cap = shardable_capacity(int(n_rows), n_shards,
                             min(chunk_size, -(-int(n_rows) // n_shards)))
    if quantization == "bq":
        row_bytes = (dim // 32) * 4
    elif quantization in ("pq", "pq4"):
        row_bytes = dim // 4
    else:
        row_bytes = dim * 2  # bf16 rows
    components = {
        "codes" if quantization != "none" else "vectors": cap * row_bytes,
        "valid": cap * 1,
        "sq_norms": cap * 4 if quantization == "none" else 0,
        "rescore_rows": cap * dim * rescore_bytes_per_dim,
    }
    components = {k: v for k, v in components.items() if v}
    total = sum(components.values())
    per_host = total // n_hosts
    rows_per_host = cap // n_hosts
    return {
        "rows": int(n_rows),
        "capacity": cap,
        "shards": n_shards,
        "hosts": n_hosts,
        "rowsPerHost": rows_per_host,
        "rowsPerDevice": cap // n_shards,
        "components": components,
        "totalBytes": total,
        "perHostBytes": {f"host-{i}": per_host + (total - per_host
                                                  * n_hosts if i == 0
                                                  else 0)
                         for i in range(n_hosts)},
    }
