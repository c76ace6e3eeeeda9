"""Serial FFT backend selection (L1 tier).

Reference analog: ``mpiFFT4py/serialFFT/__init__.py`` picks pyfftw if importable,
else numpy (SURVEY.md §2.1 #6).  Here the tiers are:

* ``xla_fft``   — ``jnp.fft`` wrappers (cuFFT on GPUs — the FFTW analog and
  the default).
* ``ops.fft_core`` — an einsum four-step/matmul FFT, off by default, used by
  the distributed transforms through the dispatch in ``ops.fft_core``.

This package exports the ``xla_fft`` surface as the canonical call signatures;
the distributed L3 classes choose the fast path per (size, dtype) via
``mpifft4py_tpu.ops.fft_core.use_matmul_fft`` exactly the way the reference let
FFTW's planner pick an algorithm per plan key.
"""

from .xla_fft import (  # noqa: F401
    fft, ifft, fft2, ifft2, fftn, ifftn,
    rfft, irfft, rfft2, irfft2, rfftn, irfftn,
    dct, idct,
)
