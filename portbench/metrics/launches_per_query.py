"""Launches of the port's hand-written kernels (``ops.kernels
.launch_counts``, summed over kernels) over the warm-up and the window,
a good reply of theirs."""


def read(run):
    n = sum(run.c1["launches"][k] - run.c0["launches"][k] for k in run.c1["launches"])
    return n / run.ok_since_c0 if run.ok_since_c0 else None
