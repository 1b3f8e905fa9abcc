"""Service, seen from the client: the 95th percentile of the latency of
every webhook call answered with a verdict inside the window, in ms, from
the call's send to its last byte."""

from admission_bench.stats import percentile


def read(run: dict) -> float | None:
    t0, t1 = run["window"]
    return percentile(
        [(done - sent) * 1e3 for sent, done, kind in run["calls"]
         if kind == 0 and t0 <= done <= t1], 95)
