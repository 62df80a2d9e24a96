"""Internal cluster transport: the error types only (port of
``weaviate_tpu/cluster/transport.py``).

``api/rest.py`` and ``api/grpc/server.py`` map ``CircuitOpenError`` to a
503 / UNAVAILABLE answer, so the types exist here with the JAX
package's fields. The transport itself (``InternalServer``, ``rpc``,
the per-peer circuit breakers) carries node-to-node traffic and is
ROADMAP Queue 1 item 7b, with the rest of the cluster.
"""

from __future__ import annotations


class RpcError(RuntimeError):
    #: True when the failure was a per-attempt timeout: the call already
    #: burned its full time ceiling, so the retry policy treats it as
    #: terminal (failover handles it) instead of burning another ceiling
    timed_out = False

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class CircuitOpenError(RpcError):
    """Fail-fast refusal: the peer's breaker is open. Subclasses
    RpcError so every per-replica failure handler treats it like the
    dead peer it represents. Carries the breaker's retry hint."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message, status=503)
        self.retry_after_s = retry_after_s
