"""Samplers, warps, correlation and the DCCL lookup, with the CUDA kernels
under ``ops.kernels``."""
