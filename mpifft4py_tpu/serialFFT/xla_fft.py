"""L1 serial-FFT tier: XLA-backed functional transforms.

Analog of the reference backends ``mpiFFT4py/serialFFT/pyfftw_fft.py``
(FFTW plan-cache wrappers) and ``numpy_fft.py`` (reference mount empty at build
time; parity target: SURVEY.md §2.1 components #6–8).

Design mapping (reference → here):

* FFTW *plans* cached per (shape, dtype, axes)  →  XLA compiled executables
  cached by jit; first call at a new shape compiles (the "planning" step),
  subsequent calls hit the executable cache.
* Out-parameter convention ``fu = rfft2(u, fu, axes=...)`` → pure functions that
  *accept and ignore* the out argument (XLA owns buffers).  All wrappers keep the
  reference call signature, including ``threads=`` and ``planner_effort=`` kwargs,
  which are accepted and ignored.
* ``dct`` (scipy.fftpack semantics, used by Shen-basis solvers) is implemented
  via even-extension FFTs so it runs on any XLA backend — see ``dct.py``.

Every function is safe to call inside ``jit``/``shard_map`` — they are thin
``jnp.fft`` calls and compose with sharding.

Normalisation follows numpy ("backward"): forward unscaled, inverse scaled by
1/N — identical to what the reference's wrappers expose to L3.
"""

from __future__ import annotations

import jax.numpy as jnp

from .dct import dct, idct  # re-exported; part of the reference L1 surface

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "dct", "idct",
]


def _ignore(kw):
    # Reference kwargs with no XLA meaning: threads, planner_effort.
    kw.pop("threads", None)
    kw.pop("planner_effort", None)
    if kw:
        raise TypeError(f"unexpected kwargs: {sorted(kw)}")


# ---- complex-to-complex -----------------------------------------------------

def fft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return jnp.fft.fft(a, axis=axis)


def ifft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return jnp.fft.ifft(a, axis=axis)


def fft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return jnp.fft.fft2(a, axes=axes)


def ifft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return jnp.fft.ifft2(a, axes=axes)


def fftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    return jnp.fft.fftn(a, axes=axes)


def ifftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    return jnp.fft.ifftn(a, axes=axes)


# ---- real-to-complex / complex-to-real -------------------------------------

def rfft(a, b=None, axis=-1, **kw):
    _ignore(kw)
    return jnp.fft.rfft(a, axis=axis)


def irfft(a, b=None, axis=-1, n=None, **kw):
    _ignore(kw)
    return jnp.fft.irfft(a, n=n, axis=axis)


def rfft2(a, b=None, axes=(-2, -1), **kw):
    _ignore(kw)
    return jnp.fft.rfft2(a, axes=axes)


def irfft2(a, b=None, axes=(-2, -1), s=None, **kw):
    _ignore(kw)
    return jnp.fft.irfft2(a, s=s, axes=axes)


def rfftn(a, b=None, axes=None, **kw):
    _ignore(kw)
    return jnp.fft.rfftn(a, axes=axes)


def irfftn(a, b=None, axes=None, s=None, **kw):
    _ignore(kw)
    return jnp.fft.irfftn(a, s=s, axes=axes)
