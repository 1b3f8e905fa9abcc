"""Micro-batcher (``runtime/batcher.py``): rows per dispatched micro-batch
over the window, from the batcher's counters."""


def read(run: dict) -> float | None:
    b0, b1 = run["counters"]["before"]["batcher"], run["counters"]["after"]["batcher"]
    batches = b1["batches_dispatched"] - b0["batches_dispatched"]
    if batches <= 0:
        return None
    return (b1["requests_dispatched"] - b0["requests_dispatched"]) / batches
