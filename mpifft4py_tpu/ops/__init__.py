"""Compute kernels: einsum four-step FFT, double-word (emulated fp64) arithmetic."""
