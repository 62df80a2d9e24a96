"""The trace reduction on a made-up profile: the busy time is the union
of the device intervals, and each idle gap goes to the op before it."""

from types import SimpleNamespace

import pytest
import torch

from portbench.trace import read_trace


class _Event:
    def __init__(self, start, dur, name, dev=True):
        self._s, self._d, self._n = start, dur, name
        self._t = torch.autograd.DeviceType.CUDA if dev else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n

    def device_type(self):
        return self._t


def _prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def test_busy_is_the_union_and_gaps_go_to_the_op_before():
    ev = [_Event(0, 100, "a"), _Event(50, 100, "b"),    # one busy span 0-150
          _Event(400, 100, "a"),                         # gap 250 after b
          _Event(600, 10, "c"), _Event(600, 5, "d"),     # gap 100 after a
          _Event(0, 10_000, "host", dev=False)]
    tr = read_trace(_prof(ev), window_s=1e-6)
    assert tr.busy_s == pytest.approx(260e-9)
    assert tr.device_events == 5
    assert tr.top_gaps() == [["after b", pytest.approx(250e-9)],
                             ["after a", pytest.approx(100e-9)]]
    assert tr.op_seconds("a") == pytest.approx(200e-9)


def test_no_device_events():
    tr = read_trace(_prof([_Event(0, 5, "host", dev=False)]), window_s=1.0)
    assert tr.busy_s == 0 and tr.device_events == 0 and tr.top_gaps() == []
