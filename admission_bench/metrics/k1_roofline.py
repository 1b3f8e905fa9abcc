"""Kernel K1 (``csrc/policy_matrix.cu``): the share, in %, of K1's summed
kernel time in the trace that the bytes it must move would take at the
card's published bandwidth (H100 SXM, 3.35 TB/s, stated at a 700 W power
limit; the result line gives the card's limit). Bytes come from the shapes
the harness recorded around ``ops/cuda_kernels.py::policy_matrix``
(``trace.k1_launch_bytes``), scaled to the launches the trace holds."""


def read(run: dict) -> float | None:
    t, k1 = run["trace"], run["k1"]
    if t is None or k1 is None or not k1["launches"] or not t["k1_kernels"]:
        return None
    traced_bytes = k1["bytes"] * t["k1_kernels"] / k1["launches"]
    return 100.0 * traced_bytes / run["hbm_bytes_per_s"] / t["k1_seconds"]
