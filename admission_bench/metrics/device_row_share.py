"""Micro-batcher (``runtime/batcher.py``): the share of the window's rows
that took the card's route, 1 - host-routed rows / rows dispatched, from
the batcher's and the environment's counters. The two counters are read a
batch apart at most (the batcher counts a row at dispatch, the environment
a host-routed row when it is answered), so a batch in flight at either end
of the window can carry the share a hair past 0 or 1; it is held there."""


def read(run: dict) -> float | None:
    c0, c1 = run["counters"]["before"], run["counters"]["after"]
    rows = c1["batcher"]["requests_dispatched"] - c0["batcher"]["requests_dispatched"]
    if rows <= 0:
        return None
    host = c1["host_fastpath_requests"] - c0["host_fastpath_requests"]
    return min(1.0, max(0.0, 1.0 - host / rows))
