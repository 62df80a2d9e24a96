"""Arithmetic the metric readers share."""

from __future__ import annotations

import math

import numpy as np


def p95_ms(lat, ok) -> float | None:
    """The 95th percentile of request latency, send to reply on the
    client's clock, in ms, over the records given (nearest rank: the value
    with 95% of them at or below it). A request without a good reply
    counts as past any limit."""
    if len(lat) == 0:
        return None
    ms = np.where(ok & (lat["t_done"] >= 0),
                  (lat["t_done"] - lat["t_send"]) / 1e6, np.inf)
    ms.sort()
    return float(ms[max(0, math.ceil(0.95 * len(ms)) - 1)])

