"""From the process's start to the first timed request: the data drawn,
the server started, the import, the LSM drained, the plane's reply cache
filled and the traffic warmed (CLOCK_BOOTTIME)."""


def read(run):
    return run.setup_s
