"""Device (``evaluation/environment.py::_device_step``): the share of the
traced window in which no kernel, copy or set ran on the card, from the
harness's ``torch.profiler`` trace."""


def read(run: dict) -> float | None:
    t = run["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
