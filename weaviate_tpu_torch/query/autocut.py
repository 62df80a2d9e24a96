"""Autocut: truncate a ranked result list at natural score jumps (a copy
of ``weaviate_tpu/query/autocut.py``).

Reference semantics (entities/autocut/autocut.go): normalize the score
curve to the unit square, subtract the diagonal, and cut at the index of
the ``cut_off``-th local maximum of the residual — i.e. the point just
before the curve's steepest drops. Works on distances (ascending) and on
scores mapped to ascending order alike.
"""

from __future__ import annotations

import numpy as np


def autocut(values, cut_off: int) -> int:
    """Return the cut index into ``values`` (ascending ranking metric).

    ``cut_off`` is the number of score "jumps" to keep; <=0 disables the
    cut (returns len(values)).
    """
    values = np.asarray(values, dtype=np.float32)
    n = len(values)
    if n <= 1 or cut_off <= 0:
        return n
    span = values[-1] - values[0]
    if span == 0.0:
        return n
    # residual of the normalized curve above the unit diagonal
    x = np.linspace(0.0, 1.0, n, dtype=np.float32)
    resid = (values - values[0]) / span - x

    extrema = 0
    for i in range(1, n):
        if i == n - 1:
            is_peak = n > 1 and resid[i] > resid[i - 1] and resid[i] > resid[i - 2]
        else:
            is_peak = resid[i] > resid[i - 1] and resid[i] > resid[i + 1]
        if is_peak:
            extrema += 1
            if extrema >= cut_off:
                return i
    return n


def autocut_results(results: list, cut_off: int, by: str = "distance") -> list:
    """Apply autocut to a list of SearchResults ranked by ``by``.

    ``by="distance"`` uses ascending distances; ``by="score"`` negates
    descending scores into an ascending curve first.
    """
    if cut_off <= 0 or len(results) <= 1:
        return results
    if by == "distance":
        vals = [r.distance for r in results]
    else:
        vals = [-(r.score or 0.0) for r in results]
    return results[: autocut(vals, cut_off)]
