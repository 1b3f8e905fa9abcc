"""Verdict cache (``evaluation/verdict_cache.py``): blob-tier plus
row-tier hits over blob-tier lookups in the window, from the environment's
dedup counters."""


def read(run: dict) -> float | None:
    d0, d1 = run["counters"]["before"]["dedup"], run["counters"]["after"]["dedup"]

    def delta(key: str) -> int:
        return d1[key] - d0[key]

    lookups = delta("blob_cache_hits") + delta("blob_cache_misses")
    if lookups <= 0:
        return None
    return (delta("blob_cache_hits") + delta("cache_hits")) / lookups
