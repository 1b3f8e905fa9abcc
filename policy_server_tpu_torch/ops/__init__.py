"""Codec, IR, optimizer, compiler and the CUDA kernels."""
