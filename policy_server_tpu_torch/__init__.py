"""Kubewarden policy-server on PyTorch and CUDA.

Serves ``/validate/{policy_id}`` for builtin policy sets on an NVIDIA card:
requests are encoded into packed feature rows on the host and every
policy's verdict for a micro-batch comes from one launch of a hand-written
CUDA kernel (``ops/cuda_kernels.py``, ``csrc/policy_matrix.cu``).
"""

__version__ = "0.1.0"
