"""1 - (union of the device operations' intervals) / (the profiled span),
from torch.profiler's CUDA activity over the middle of the window."""


def read(run):
    tr = run.dtrace
    if tr is None or tr.device_events == 0 or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
