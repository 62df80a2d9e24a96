"""Device-mesh helpers for one card (port of
``weaviate_tpu/parallel/mesh.py``).

The JAX package builds a 1-D or hierarchical mesh when a coordinator is
named (``DCN_COORDINATOR_ADDRESS``) or virtual hosts are asked for
(``WEAVIATE_TPU_VIRTUAL_HOSTS`` > 1). The port serves one device: those
settings raise, and every mesh argument other than ``None`` raises.
Multi-device serving is ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import os

MULTI_DEVICE = "multi-device serving: ROADMAP Queue 1 item 6"

#: env knobs that put the JAX server on a mesh
COORDINATOR_ENV = "DCN_COORDINATOR_ADDRESS"
VIRTUAL_HOSTS_ENV = "WEAVIATE_TPU_VIRTUAL_HOSTS"


def virtual_hosts(env=None) -> int | None:
    """WEAVIATE_TPU_VIRTUAL_HOSTS as an int, or None when unset/invalid."""
    env = env if env is not None else os.environ
    raw = env.get(VIRTUAL_HOSTS_ENV)
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n >= 1 else None


def require_single_device(env=None) -> None:
    """Raise where the JAX server would join a multi-host runtime or
    serve over a mesh; the port never serves those modes on one card."""
    env = env if env is not None else os.environ
    if env.get(COORDINATOR_ENV):
        raise NotImplementedError(f"{COORDINATOR_ENV}: {MULTI_DEVICE}")
    if (virtual_hosts(env) or 1) > 1:
        raise NotImplementedError(f"{VIRTUAL_HOSTS_ENV}: {MULTI_DEVICE}")


def host_count(mesh=None) -> int:
    """Hosts backing the serving placement: one, without a mesh."""
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE)
    return 1
