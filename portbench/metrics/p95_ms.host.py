"""The tail of the traced run's window, in a cell whose card is idle
most of the window, so that the host alone paces it: the 95th percentile
of send-to-reply over every request sent inside the window (client's
clock)."""

from portbench.stats import p95_ms


def read(run):
    return p95_ms(run.lat, run.ok)
