"""Sharding state: object -> physical shard routing.

Reference: usecases/sharding/state.go — physical shards with virtual-shard
ring, object routed by murmur3 of the UUID (state.go:167-176); multi-tenant
collections use one shard per tenant (state.go:293).

This implementation keeps the same contract (stable uuid -> shard mapping,
fixed shard count at creation, tenant = shard name) with xxhash64 as the
ring hash — we don't need wire compatibility with the reference, only
stability and dispersion.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import xxhash


def _hash64(s: str) -> int:
    return xxhash.xxh64_intdigest(s)


@dataclass
class ShardingState:
    shard_names: list[str] = field(default_factory=list)
    partitioning_enabled: bool = False  # multi-tenancy
    # node placement: shard name -> list of node names (replication)
    placement: dict[str, list[str]] = field(default_factory=dict)
    # tenant activity status (reference: HOT/COLD tenant offload,
    # models.TenantActivityStatus); absent = HOT
    tenant_status: dict[str, str] = field(default_factory=dict)

    @classmethod
    def create(cls, shard_count: int, nodes: list[str] | None = None,
               replication_factor: int = 1) -> "ShardingState":
        names = [f"shard-{i}" for i in range(shard_count)]
        nodes = nodes or ["node-0"]
        placement = {}
        for i, name in enumerate(names):
            placement[name] = [
                nodes[(i + r) % len(nodes)] for r in range(min(replication_factor,
                                                               len(nodes)))
            ]
        return cls(shard_names=names, placement=placement)

    @classmethod
    def create_partitioned(cls) -> "ShardingState":
        """Multi-tenant: shards appear per tenant."""
        return cls(shard_names=[], partitioning_enabled=True)

    def shard_for(self, uuid: str, tenant: str | None = None) -> str:
        if self.partitioning_enabled:
            if not tenant:
                raise ValueError("multi-tenant collection requires a tenant")
            return tenant
        if not self.shard_names:
            raise ValueError("sharding state has no shards")
        return self.shard_names[_hash64(uuid) % len(self.shard_names)]

    def add_tenant(self, tenant: str, nodes: list[str] | None = None,
                   replication_factor: int = 1):
        if not self.partitioning_enabled:
            raise ValueError("not a multi-tenant collection")
        if tenant not in self.shard_names:
            self.shard_names.append(tenant)
            nodes = nodes or ["node-0"]
            start = _hash64(tenant) % len(nodes)
            self.placement[tenant] = [
                nodes[(start + r) % len(nodes)]
                for r in range(min(replication_factor, len(nodes)))
            ]

    def remove_tenant(self, tenant: str):
        if tenant in self.shard_names:
            self.shard_names.remove(tenant)
            self.placement.pop(tenant, None)
            self.tenant_status.pop(tenant, None)

    def nodes_for(self, shard: str) -> list[str]:
        return self.placement.get(shard, ["node-0"])

    def status_of(self, tenant: str) -> str:
        return self.tenant_status.get(tenant, "HOT")

    def to_dict(self) -> dict:
        return {
            "shard_names": list(self.shard_names),
            "partitioning_enabled": self.partitioning_enabled,
            "placement": {k: list(v) for k, v in self.placement.items()},
            "tenant_status": dict(self.tenant_status),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShardingState":
        return cls(
            shard_names=list(d.get("shard_names", [])),
            partitioning_enabled=d.get("partitioning_enabled", False),
            placement={k: list(v) for k, v in d.get("placement", {}).items()},
            tenant_status=dict(d.get("tenant_status", {})),
        )
