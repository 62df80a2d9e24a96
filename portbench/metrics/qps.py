"""Good replies (grpc-status 0) that arrived inside the window, whichever
second the client sent them, over the window's seconds (host clock, the
load generator's: the loop runs on from its warm-up, so the window
opens on its steady state)."""


def read(run):
    lat = run.lat_all
    t = lat["t_done"]
    inside = (lat["status"] == 0) & (t >= 0) & (t <= run.seconds * 1e9)
    return float(inside.sum()) / run.seconds
