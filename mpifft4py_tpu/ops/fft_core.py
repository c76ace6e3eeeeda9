"""Einsum four-step FFT tier (off by default; XLA's FFT is the default).

Reference analog: mpiFFT4py's serial backend is FFTW via pyfftw (SURVEY.md §2.1
#7); here the default is ``jnp.fft`` (cuFFT on GPUs).  This module adds the
**four-step (Bailey) FFT** as an alternative: factor n = n1·n2 and express
the length-n DFT as

    X[k1 + n1·k2] = Σ_{j2} W2[k2,j2] · ( T[k1,j2] · Σ_{j1} W1[k1,j1] x[j1·n2+j2] )

i.e. two *dense batched matmuls* against small DFT matrices with an elementwise
twiddle in between — O(n1+n2) flops per element instead of O(log n).  Dense
DFT matrices give every radix for free (the 3/2-rule padded sizes 96, 384,
1536 = 3·2^k need no special-casing).

Accuracy: contractions run at ``lax.Precision.HIGHEST`` (full float32 — no
TF32 or bf16 passes); twiddles are computed in float64 on host and rounded
once.  r2c/c2r use the Hermitian pack/unpack trick (length-n real transform
via one length-n/2 complex transform + elementwise untangle).

Dispatch: ``fft/ifft/rfft/irfft`` mirror ``jnp.fft`` signatures and choose
matmul vs XLA FFT via ``use_matmul_fft`` — the role FFTW's planner played for
the reference.  ``MPIFFT4PY_TPU_FFT_BACKEND={matmul,xla}`` selects the tier.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["fft", "ifft", "rfft", "irfft", "fft_matmul", "ifft_matmul",
           "rfft_matmul", "irfft_matmul", "use_matmul_fft"]

_PREC = lax.Precision.HIGHEST


def _ctype(x_dtype) -> np.dtype:
    if np.dtype(x_dtype) in (np.float64, np.complex128):
        return np.dtype(np.complex128)
    return np.dtype(np.complex64)


def best_factor(n: int) -> int:
    """Largest factor of n that is <= sqrt(n) (balanced four-step split)."""
    f = int(np.sqrt(n))
    while n % f:
        f -= 1
    return f


@lru_cache(maxsize=None)
def _dft_mat(n: int, sign: int, dtype_str: str) -> np.ndarray:
    k = np.arange(n)
    W = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return W.astype(dtype_str)


@lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, sign: int, dtype_str: str) -> np.ndarray:
    k1 = np.arange(n1)[:, None]
    j2 = np.arange(n2)[None, :]
    return np.exp(sign * 2j * np.pi * k1 * j2 / (n1 * n2)).astype(dtype_str)


_LET = "abcdefghmnopqrstuvwxyz"  # free-index letters (j,k,l reserved)


def _fft_axis(x: jnp.ndarray, axis: int, sign: int) -> jnp.ndarray:
    """Unscaled DFT along ``axis`` via four-step matmuls, in place (no moveaxis:
    einsum contracts the axis directly, so XLA picks layouts; sign=-1 fwd)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    cdt = _ctype(x.dtype)
    pre = _LET[:axis]
    post = _LET[axis:x.ndim - 1]
    if n == 1:
        return x.astype(cdt)
    n1 = best_factor(n)
    if n1 == 1:  # prime size: single dense DFT matmul
        W = jnp.asarray(_dft_mat(n, sign, str(cdt)))
        return jnp.einsum(f"kj,{pre}j{post}->{pre}k{post}", W, x, precision=_PREC)
    n2 = n // n1
    W1 = jnp.asarray(_dft_mat(n1, sign, str(cdt)))
    W2 = jnp.asarray(_dft_mat(n2, sign, str(cdt)))
    T = jnp.asarray(_twiddle(n1, n2, sign, str(cdt)))
    v = x.reshape(x.shape[:axis] + (n1, n2) + x.shape[axis + 1:])
    # A[.., k1, j2, ..] = Σ_j1 W1[k1,j1] v[.., j1, j2, ..]
    a = jnp.einsum(f"kj,{pre}jl{post}->{pre}kl{post}", W1, v, precision=_PREC)
    a = a * T.reshape((1,) * axis + (n1, n2) + (1,) * len(post))
    # X[.., k1, k2, ..] = Σ_j2 a[.., k1, j2, ..] W2[k2,j2]
    out = jnp.einsum(f"lj,{pre}kj{post}->{pre}lk{post}", W2, a, precision=_PREC)
    # out is indexed (k2, k1) at (axis, axis+1); flat k = k1 + n1·k2 ⇒ reshape
    return out.reshape(x.shape[:axis] + (n,) + x.shape[axis + 1:])


def _fft_last(x: jnp.ndarray, sign: int) -> jnp.ndarray:
    return _fft_axis(x, x.ndim - 1, sign)


def _move(x, axis):
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        return x, None
    return jnp.moveaxis(x, axis, -1), axis


def _unmove(x, axis):
    if axis is None:
        return x
    return jnp.moveaxis(x, -1, axis)


def fft_matmul(x, axis=-1):
    """Forward c2c DFT along ``axis`` (numpy conventions, unscaled)."""
    return _fft_axis(x.astype(_ctype(x.dtype)), axis, -1)


def ifft_matmul(x, axis=-1):
    """Inverse c2c DFT along ``axis`` (scaled by 1/n)."""
    cdt = _ctype(x.dtype)
    n = x.shape[axis % x.ndim]
    return _fft_axis(x.astype(cdt), axis, +1) * cdt.type(1.0 / n)


def rfft_matmul(x, axis=-1):
    """Real→complex DFT via the Hermitian pack trick: one n/2 complex FFT."""
    n = x.shape[axis % x.ndim]
    assert n % 2 == 0, f"rfft_matmul needs even length, got {n}"
    y, ax = _move(x, axis)
    h = n // 2
    cdt = np.dtype(np.complex128) if x.dtype == np.float64 else np.dtype(np.complex64)
    z = lax.complex(y[..., 0::2], y[..., 1::2]).astype(cdt)      # pack pairs
    Z = _fft_last(z, -1)                                          # (..., h)
    # untangle: X[k] = (Z[k]+conj(Z[h-k]))/2 - (i/2) e^{-2πik/n} (Z[k]-conj(Z[h-k]))
    Zr = jnp.concatenate([Z[..., :1], jnp.flip(Z[..., 1:], -1)], axis=-1)
    Zc = jnp.conj(Zr)
    k = np.arange(h)
    w = jnp.asarray(np.exp(-2j * np.pi * k / n).astype(cdt))
    Xk = 0.5 * (Z + Zc) - 0.5j * w * (Z - Zc)                     # k = 0..h-1
    nyq = (jnp.real(Z[..., :1]) - jnp.imag(Z[..., :1])).astype(cdt)  # X[h]
    out = jnp.concatenate([Xk, nyq], axis=-1)                      # (..., h+1)
    return _unmove(out, ax)


def irfft_matmul(x, axis=-1, n=None):
    """Complex→real inverse DFT (numpy irfft semantics, scaled by 1/n)."""
    y, ax = _move(x, axis)
    nf = y.shape[-1]
    if n is None:
        n = 2 * (nf - 1)
    assert n % 2 == 0 and nf == n // 2 + 1, (n, nf)
    h = n // 2
    cdt = _ctype(y.dtype)
    y = y.astype(cdt)
    # rebuild Z[k] (the packed h-point spectrum) from X[0..h]
    Xk = y[..., :h]                                                # X[0..h-1]
    Xr = jnp.concatenate([y[..., h:h + 1], jnp.flip(y[..., 1:h], -1)], axis=-1)
    Xc = jnp.conj(Xr)                                              # conj X[h-k]
    k = np.arange(h)
    w = jnp.asarray(np.exp(+2j * np.pi * k / n).astype(cdt))
    A = 0.5 * (Xk + Xc)
    B = 0.5j * w * (Xk - Xc)
    Z = A + B                                                      # fft(z)[k]
    z = _fft_last(Z, +1) * cdt.type(1.0 / h)                       # inverse, len h
    even = jnp.real(z)
    odd = jnp.imag(z)
    out = jnp.stack([even, odd], axis=-1).reshape(z.shape[:-1] + (n,))
    rdt = np.float64 if cdt == np.complex128 else np.float32
    return _unmove(out.astype(rdt), ax)


# ---- dispatch ---------------------------------------------------------------

def _backend_override():
    return os.environ.get("MPIFFT4PY_TPU_FFT_BACKEND", "").lower()


def use_matmul_fft(n: int) -> bool:
    """Planner policy for the einsum four-step tier: XLA's FFT unless
    ``MPIFFT4PY_TPU_FFT_BACKEND=matmul``.  The unfused four-step pipeline
    makes about three memory passes per axis where one FFT makes one, so it
    is not the default; its speed on the GPU is not measured."""
    ov = _backend_override()
    if ov == "matmul":
        return True
    return False


def fft(x, axis=-1):
    n = x.shape[axis % x.ndim]
    return fft_matmul(x, axis) if use_matmul_fft(n) else jnp.fft.fft(x, axis=axis)


def ifft(x, axis=-1):
    n = x.shape[axis % x.ndim]
    return ifft_matmul(x, axis) if use_matmul_fft(n) else jnp.fft.ifft(x, axis=axis)


def rfft(x, axis=-1):
    n = x.shape[axis % x.ndim]
    if use_matmul_fft(n) and n % 2 == 0:
        return rfft_matmul(x, axis)
    return jnp.fft.rfft(x, axis=axis)


def irfft(x, axis=-1, n=None):
    nn = n if n is not None else 2 * (x.shape[axis % x.ndim] - 1)
    if use_matmul_fft(nn) and nn % 2 == 0:
        return irfft_matmul(x, axis, n=nn)
    return jnp.fft.irfft(x, n=nn, axis=axis)


# 2D composites used by the slab local stages (dispatch per axis/size).

def rfft2(x, axes=(-2, -1)):
    return fft(rfft(x, axis=axes[1]), axis=axes[0])


def irfft2(x, s, axes=(-2, -1)):
    return irfft(ifft(x, axis=axes[0]), axis=axes[1], n=s[1])


def fft2(x, axes=(-2, -1)):
    return fft(fft(x, axis=axes[1]), axis=axes[0])


def ifft2(x, axes=(-2, -1)):
    return ifft(ifft(x, axis=axes[1]), axis=axes[0])
