"""What a profiler trace of the traced window says: the seconds in which
an operation ran on the device, each device operation's total, and the
device's idle time summed by the operation that ran before each gap."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

TOP = 10


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float = 0.0
    ops: dict = field(default_factory=dict)    # device op name -> seconds
    idle: dict = field(default_factory=dict)   # "after <op>" -> idle seconds
    device_events: int = 0

    def top_ops(self) -> list:
        return sorted(([k, v] for k, v in self.ops.items()), key=lambda x: -x[1])[:TOP]

    def top_gaps(self) -> list:
        return sorted(([k, v] for k, v in self.idle.items()), key=lambda x: -x[1])[:TOP]

    def op_seconds(self, *needles: str) -> float:
        """Seconds of the device ops whose name holds any of ``needles``."""
        return sum(v for k, v in self.ops.items() if any(n in k for n in needles))


def read_trace(prof, window_s: float) -> DeviceTrace:
    """Reduce a stopped ``torch.profiler.profile`` to a ``DeviceTrace``."""
    dev = []
    tr = DeviceTrace(window_s=window_s)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            dev.append((s, s + d, name))
            tr.ops[name] = tr.ops.get(name, 0.0) + d / 1e9
    tr.device_events = len(dev)
    # one sweep in order of start: the union of the intervals (busy), and
    # each gap between them put to the op that ended last before it
    busy = 0
    end, last = None, ""
    for s, e, name in sorted(dev):
        if end is None:
            start, end, last = s, e, name
        elif s > end:
            busy += end - start
            key = f"after {last}"
            tr.idle[key] = tr.idle.get(key, 0.0) + (s - end) / 1e9
            start, end, last = s, e, name
        elif e > end:
            end, last = e, name
    if end is not None:
        busy += end - start
    tr.busy_s = busy / 1e9
    return tr
