"""Kernel scope: configuration and the per-query EXPLAIN sink only (port
of ``weaviate_tpu/runtime/kernelscope.py``).

What the server and the REST/gRPC handlers call is here: ``configure``
(where captures would persist and how many to keep) and the request-level
EXPLAIN sink (``explain_begin`` / ``explain_end``, a context variable that
the port's engine does not fill yet, so a plan comes back empty). The
device-time plane — residency meters, the memcpy model, the snapshot and
the on-demand kernel captures behind ``/v1/debug/profile`` (CUDA events
and ``torch.profiler``) — is ROADMAP Queue 1 item 8: those entry points
raise, and the REST mapping answers 500 with that message.
"""

from __future__ import annotations

import contextvars

NOT_PORTED = "kernelscope device-time plane: ROADMAP Queue 1 item 8"

_data_dir: str | None = None
_keep = 8


def configure(data_dir: str | None = None, keep: int | None = None) -> None:
    """Server wiring: where captures persist (``<data_dir>/kernelscope``)
    and how many to keep."""
    global _data_dir, _keep
    if data_dir is not None:
        _data_dir = str(data_dir)
    if keep is not None:
        _keep = max(1, int(keep))


# -- per-query EXPLAIN --------------------------------------------------------

_explain_sink: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "kernelscope_explain_sink", default=None)


def explain_begin():
    """Install a fresh request-level explain sink on this thread;
    returns the reset token for :func:`explain_end`."""
    return _explain_sink.set({})


def explain_end(token) -> dict:
    plan = _explain_sink.get() or {}
    _explain_sink.reset(token)
    return plan


# -- the device-time plane (item 8) -------------------------------------------


def snapshot() -> dict:
    raise NotImplementedError(NOT_PORTED)


def capture_profile(ms: int, capturer=None) -> dict:
    raise NotImplementedError(NOT_PORTED)


def list_captures() -> list[dict]:
    raise NotImplementedError(NOT_PORTED)


def load_capture(capture_id: str) -> dict | None:
    raise NotImplementedError(NOT_PORTED)
