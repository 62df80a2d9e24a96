"""Collection (class) configuration model.

Reference parity:
- class schema + properties: entities/models (Class, Property), validated in
  usecases/schema/class.go:95 (AddClass defaults + validation)
- vector index configs: entities/vectorindex/{hnsw,flat,dynamic}/config.go
- sharding config: usecases/sharding/config.go (shard count fixed at
  creation)
- multi-tenancy: one shard per tenant (sharding/state.go:293)
- replication: usecases/replica/config.go (factor, consistency levels)
- inverted index config: BM25 k1/b, stopwords (entities/models +
  inverted/stopwords)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, asdict


class DataType:
    TEXT = "text"
    TEXT_ARRAY = "text[]"
    INT = "int"
    INT_ARRAY = "int[]"
    NUMBER = "number"
    NUMBER_ARRAY = "number[]"
    BOOL = "boolean"
    BOOL_ARRAY = "boolean[]"
    DATE = "date"
    DATE_ARRAY = "date[]"
    UUID = "uuid"
    UUID_ARRAY = "uuid[]"
    GEO = "geoCoordinates"
    BLOB = "blob"
    OBJECT = "object"
    REFERENCE = "cref"

    ALL = {TEXT, TEXT_ARRAY, INT, INT_ARRAY, NUMBER, NUMBER_ARRAY, BOOL,
           BOOL_ARRAY, DATE, DATE_ARRAY, UUID, UUID_ARRAY, GEO, BLOB, OBJECT,
           REFERENCE}


_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_]*$")


@dataclass
class Property:
    name: str
    data_type: str = DataType.TEXT
    tokenization: str = "word"  # word | lowercase | whitespace | field
    index_filterable: bool = True
    index_searchable: bool = True  # only meaningful for text
    description: str = ""
    nested: list["Property"] | None = None

    def validate(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(f"invalid property name {self.name!r}")
        if self.data_type not in DataType.ALL:
            raise ValueError(f"unknown data type {self.data_type!r} for {self.name}")
        if self.tokenization not in ("word", "lowercase", "whitespace", "field"):
            raise ValueError(f"unknown tokenization {self.tokenization!r}")


@dataclass
class VectorIndexConfig:
    index_type: str = "flat"  # flat | hnsw | dynamic | noop (reference set + ivf)
    metric: str = "l2-squared"
    storage_dtype: str = "float32"  # float32 | bfloat16
    # quantization
    quantization: str | None = None  # None | pq | bq
    pq_segments: int | None = None
    # TPU-first default: 16 centroids = 4-bit codes whose ADC lookup is one
    # MXU matmul (ops/pallas_kernels.pq4_lut_block); 256 selects the
    # reference-style 8-bit codebook (reconstruct-matmul scan)
    pq_centroids: int = 16
    rescore_limit: int = 16
    # two-stage scan: width (bits, 128/256) of the separately-stored
    # transposed sign prefix — the capacity-regime operating point;
    # ignored for mesh-sharded stores and dims the prefix cannot cover
    prefix_bits: int | None = None
    # hnsw-ish knobs (used by graph/ivf indexes)
    ef: int = -1
    ef_construction: int = 128
    max_connections: int = 32
    # dynamic index upgrade threshold (dynamic/index.go:348)
    flat_to_ann_threshold: int = 10_000
    # ivf
    ivf_nlist: int = 0  # 0 = auto
    ivf_nprobe: int = 0  # 0 = auto
    # epoch-stacked device corpus (engine/epochs.py): seal the active
    # epoch every N rows; sealed epochs are immutable, compact in the
    # background (deletes reclaim HBM) and can migrate under memory
    # pressure. 0 = legacy single donated buffer. Flat indexes only —
    # graph/ivf layouts have their own reorganize stories.
    epoch_rows: int = 0

    def validate(self):
        from weaviate_tpu_torch.ops.distances import DISTANCE_METRICS

        if self.index_type not in ("flat", "hnsw", "dynamic", "noop", "ivf"):
            raise ValueError(f"unknown vector index type {self.index_type!r}")
        if self.metric not in DISTANCE_METRICS:
            raise ValueError(f"unknown distance metric {self.metric!r}")
        if self.quantization not in (None, "pq", "bq"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        if self.prefix_bits is not None:
            if not isinstance(self.prefix_bits, int) \
                    or self.prefix_bits not in (128, 256):
                raise ValueError(
                    f"prefix_bits must be 128 or 256, got "
                    f"{self.prefix_bits!r}")
            if self.quantization is None:
                raise ValueError(
                    "prefix_bits requires quantization pq or bq")
        if self.epoch_rows:
            if not isinstance(self.epoch_rows, int) or self.epoch_rows < 0:
                raise ValueError(
                    f"epoch_rows must be a non-negative int, got "
                    f"{self.epoch_rows!r}")
            if self.index_type != "flat":
                raise ValueError(
                    "epoch_rows requires index_type 'flat' (graph/ivf "
                    "layouts have their own reorganize stories)")


@dataclass
class VectorConfig:
    """One named vector space (reference: hasTargetVectors, shard.go:130)."""

    name: str = ""  # "" = default/legacy single vector
    dim: int = 0  # 0 = inferred from first insert
    index: VectorIndexConfig = field(default_factory=VectorIndexConfig)
    vectorizer: str = "none"  # module name, or "none" = client provides
    # per-module settings (reference: moduleConfig per class/vector —
    # e.g. {"vectorizeClassName": false, "properties": [...]})
    module_config: dict = field(default_factory=dict)


@dataclass
class ShardingConfig:
    desired_count: int = 1
    virtual_per_physical: int = 128


@dataclass
class MultiTenancyConfig:
    enabled: bool = False
    auto_tenant_creation: bool = False
    auto_tenant_activation: bool = False


@dataclass
class ReplicationConfig:
    factor: int = 1
    async_enabled: bool = False


@dataclass
class InvertedIndexConfig:
    bm25_k1: float = 1.2
    bm25_b: float = 0.75
    stopwords_preset: str = "en"  # en | none
    stopwords_additions: list[str] = field(default_factory=list)
    stopwords_removals: list[str] = field(default_factory=list)
    index_timestamps: bool = False
    index_null_state: bool = False
    index_property_length: bool = False


@dataclass
class CollectionConfig:
    name: str
    description: str = ""
    properties: list[Property] = field(default_factory=list)
    vectors: list[VectorConfig] = field(default_factory=lambda: [VectorConfig()])
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    multi_tenancy: MultiTenancyConfig = field(default_factory=MultiTenancyConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    inverted: InvertedIndexConfig = field(default_factory=InvertedIndexConfig)
    # class-level module settings keyed by module name (reference:
    # models.Class.ModuleConfig) — generative-*, reranker-* live here
    module_config: dict = field(default_factory=dict)

    def validate(self):
        if not _NAME_RE.match(self.name) or not self.name[0].isupper():
            raise ValueError(
                f"invalid collection name {self.name!r} (GraphQL-compatible "
                "UpperCamelCase required)"
            )
        seen = set()
        for p in self.properties:
            p.validate()
            if p.name.lower() in seen:
                raise ValueError(f"duplicate property {p.name!r}")
            seen.add(p.name.lower())
        vec_names = set()
        for v in self.vectors:
            v.index.validate()
            if v.name in vec_names:
                raise ValueError(f"duplicate vector name {v.name!r}")
            vec_names.add(v.name)
        if self.sharding.desired_count < 1:
            raise ValueError("shard count must be >= 1")
        if self.replication.factor < 1:
            raise ValueError("replication factor must be >= 1")

    def property(self, name: str) -> Property | None:
        for p in self.properties:
            if p.name == name:
                return p
        return None

    def vector_config(self, name: str = "") -> VectorConfig | None:
        for v in self.vectors:
            if v.name == name:
                return v
        return None

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CollectionConfig":
        d = dict(d)
        d["properties"] = [
            Property(**{**p, "nested": None}) if not p.get("nested")
            else Property(**{**p, "nested": [Property(**n) for n in p["nested"]]})
            for p in d.get("properties", [])
        ]
        d["vectors"] = [
            VectorConfig(
                name=v.get("name", ""),
                dim=v.get("dim", 0),
                index=VectorIndexConfig(**v.get("index", {})),
                vectorizer=v.get("vectorizer", "none"),
                module_config=v.get("module_config", {}),
            )
            for v in d.get("vectors", [{}])
        ]
        d["sharding"] = ShardingConfig(**d.get("sharding", {}))
        d["multi_tenancy"] = MultiTenancyConfig(**d.get("multi_tenancy", {}))
        d["replication"] = ReplicationConfig(**d.get("replication", {}))
        d["inverted"] = InvertedIndexConfig(**d.get("inverted", {}))
        return cls(**d)
