"""Drift watch: configuration only (port of
``weaviate_tpu/runtime/driftwatch.py``).

The server and ``Database`` set where the history ring and the sealed
live baseline would live (``<data_dir>/driftwatch``), whether the plane
is on and its cycle period, with the JAX package's calls. The plane
itself — canary probes through the query batcher, the live-telemetry
classification, the findings, the drift cycle and ``/v1/debug/drift`` —
is ROADMAP Queue 1 item 8: ``snapshot`` raises, the REST mapping answers
500 with that message, and ``Database`` registers no drift cycle.
"""

from __future__ import annotations

NOT_PORTED = "driftwatch: ROADMAP Queue 1 item 8"

_forced: bool | None = None
_data_dir: str | None = None
_interval_forced: float | None = None


def set_data_dir(path: str | None) -> None:
    """Follow the most recently opened database's data dir."""
    global _data_dir
    _data_dir = path


def configure(data_dir: str | None = None, enabled: bool | None = None,
              interval: float | None = None) -> None:
    """Server-start wiring: pin the data dir, force enable/disable past
    the env default, override the cycle interval."""
    global _forced, _interval_forced
    if data_dir is not None:
        set_data_dir(data_dir)
    if enabled is not None:
        _forced = bool(enabled)
    if interval is not None:
        _interval_forced = float(interval)


def snapshot() -> dict:
    raise NotImplementedError(NOT_PORTED)
