"""Degraded-mode bookkeeping: partial-result markers + component health.

Two small registries shared by the serving layers:

- **Per-request degradation markers.** The REST/gRPC edge opens
  ``collecting()`` around each request; any layer that serves PARTIAL
  results instead of failing (a dead replica skipped by scatter-gather,
  a consistency level quietly downgraded by the finder) calls
  ``report(...)``. The edge attaches the collected markers to the
  response as an explicit ``degraded`` field — a client must never
  mistake a partial answer for a complete one. Markers ride a
  contextvar (carried onto pool threads by ``tracing.propagate``).

- **Component health.** Long-lived subsystems (query batcher, native
  data plane) flip ``mark_unhealthy``/``mark_healthy`` as their
  dispatch paths fail and recover; ``/v1/nodes`` surfaces the registry
  so an operator sees WHICH component is degraded, not just that p99
  went sideways. Mirrored in the
  ``weaviate_tpu_component_unhealthy{component}`` gauge.
"""

from __future__ import annotations

import contextvars
import threading
import time

_markers_var: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "weaviate_tpu_degraded_markers", default=None)


class _Collecting:
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _markers_var.set([])
        return self

    def __exit__(self, *exc):
        _markers_var.reset(self._token)
        return False


def collecting() -> _Collecting:
    """Request-edge scope: markers reported inside land in ``snapshot()``."""
    return _Collecting()


def current_markers() -> list | None:
    """The live marker list (for hand-off to pool threads), or None."""
    return _markers_var.get()


def set_markers(markers: list | None):
    """Install a captured marker list on a worker thread; returns the
    reset token (``tracing.propagate`` plumbing)."""
    return _markers_var.set(markers)


def reset_markers(token) -> None:
    _markers_var.reset(token)


def report(kind: str, *, collection: str = "", shard: str = "",
           node: str = "", detail: str = "") -> None:
    """Record one degradation: the request edge surfaces it, the counter
    accounts for it even when no edge is collecting (direct API use)."""
    marker = {"kind": kind}
    if collection:
        marker["collection"] = collection
    if shard:
        marker["shard"] = shard
    if node:
        marker["node"] = node
    if detail:
        marker["detail"] = detail
    markers = _markers_var.get()
    if markers is not None:
        markers.append(marker)
    try:
        from weaviate_tpu_torch.runtime.metrics import degraded_results_total

        degraded_results_total.labels(kind, collection or "-").inc()
    except Exception:  # pragma: no cover
        pass
    try:
        from weaviate_tpu_torch.runtime import tracing

        tracing.annotate(degraded=kind)
    except Exception:  # pragma: no cover
        pass


def snapshot() -> list[dict]:
    """The markers collected so far in this request (empty when none, or
    when no edge is collecting)."""
    markers = _markers_var.get()
    return list(markers) if markers else []


# -- component health ----------------------------------------------------------

_health_lock = threading.Lock()
_unhealthy: dict[str, dict] = {}


def mark_unhealthy(component: str, reason: str) -> None:
    """Flip a component's health flag (idempotent; first reason+time
    stick until it recovers)."""
    with _health_lock:
        if component not in _unhealthy:
            _unhealthy[component] = {"reason": reason,
                                     "since": time.time()}
            _set_gauge(component, 1.0)
        else:
            _unhealthy[component]["reason"] = reason


def mark_healthy(component: str) -> None:
    with _health_lock:
        if _unhealthy.pop(component, None) is not None:
            _set_gauge(component, None)


def is_unhealthy(component: str) -> bool:
    """Lock-free membership probe (benign race): lets hot paths skip
    the mark_healthy lock when the component was never flagged."""
    return component in _unhealthy


def health() -> dict:
    """``{"healthy": bool, "unhealthy": {component: {reason, since}}}`` —
    the ``/v1/nodes`` payload."""
    with _health_lock:
        bad = {k: dict(v) for k, v in _unhealthy.items()}
    return {"healthy": not bad, "unhealthy": bad}


def _set_gauge(component: str, value: float | None) -> None:
    try:
        from weaviate_tpu_torch.runtime.metrics import component_unhealthy

        if value is None:
            component_unhealthy.remove(component)
        else:
            component_unhealthy.labels(component).set(value)
    except Exception:  # pragma: no cover
        pass


def reset() -> None:
    """Test hook: clear the health registry."""
    with _health_lock:
        for component in list(_unhealthy):
            _unhealthy.pop(component)
            _set_gauge(component, None)
