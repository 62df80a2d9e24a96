"""Mean host ms of ``Shard.allow_mask``, the filter's evaluation into a
mask over the shard's doc ids, a call (one a filtered request; harness
wrapper, the whole window)."""


def read(run):
    calls = run.probe.calls["allow_mask"]
    return sum(e - s for s, e in calls) / len(calls) / 1e6 if calls else None
