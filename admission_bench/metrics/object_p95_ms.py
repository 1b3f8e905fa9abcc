"""Service, seen from the client: the 95th percentile over the object
writes whose last answer arrived inside the window of the time from the
write's first call to its last answer, in ms: what the API server waits
for before it can persist the object."""

from admission_bench.stats import percentile


def read(run: dict) -> float | None:
    t0, t1 = run["window"]
    return percentile(
        [(done - start) * 1e3 for start, done, ok in run["objects"]
         if ok and t0 <= done <= t1], 95)
