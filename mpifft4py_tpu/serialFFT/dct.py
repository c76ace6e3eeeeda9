"""Discrete cosine transforms (types 1–4) on top of XLA FFTs.

The reference's FFTW backend exposes ``dct`` (scipy.fftpack semantics) for
Shen-basis spectral solvers (SURVEY.md §2.1 #7, [K:med]).  XLA has no DCT
primitive, so these are built from even-extension FFTs — pure ``jnp`` ops, jittable and
shardable.  Conventions match ``scipy.fftpack.dct``/``idct`` with ``norm=None``:

* type 2 (default):  ``y[k] = 2 Σ_n x[n] cos(πk(2n+1)/(2N))``
* type 3:            ``y[k] = x[0] + 2 Σ_{n≥1} x[n] cos(πn(2k+1)/(2N))``
* type 1:            ``y[k] = x[0] + (-1)^k x[N-1] + 2 Σ_{0<n<N-1} x[n] cos(πnk/(N-1))``

``idct(dct(x, type=2), type=2) == x`` (the 1/(2N) factor is applied by ``idct``),
mirroring scipy's type-2/3 inverse pairing.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["dct", "idct"]


def _dct2(x, axis):
    n = x.shape[axis]
    ext = jnp.concatenate([x, jnp.flip(x, axis=axis)], axis=axis)
    F = jnp.fft.fft(ext, axis=axis)
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    phase = jnp.exp(-1j * jnp.pi * k / (2 * n)).reshape(shape)
    return jnp.real(phase * jnp.take(F, jnp.arange(n), axis=axis)).astype(x.dtype)


def _dct3(x, axis):
    n = x.shape[axis]
    # c[0] = x[0], c[n>=1] = 2 x[n];  d[n] = c[n] exp(i π n / (2N));
    # y[k] = Re( FFT_{2N}(conj(d ⊕ 0))[k] ),  k = 0..N-1.
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    w = jnp.where(k == 0, 1.0, 2.0).reshape(shape)
    phase = jnp.exp(1j * jnp.pi * k / (2 * n)).reshape(shape)
    d = x * w * phase
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n)
    dpad = jnp.pad(jnp.conj(d), pad)
    F = jnp.fft.fft(dpad, axis=axis)
    return jnp.real(jnp.take(F, jnp.arange(n), axis=axis)).astype(x.dtype)


def _dct4(x, axis):
    n = x.shape[axis]
    # y[k] = 2 Re{ e^{-iπ(2k+1)/(4N)} · FFT_{2N}(x[n] e^{-iπn/(2N)} ⊕ 0)[k] }
    k = jnp.arange(n)
    shape = [1] * x.ndim
    shape[axis] = n
    pre = jnp.exp(-1j * jnp.pi * k / (2 * n)).reshape(shape)
    post = jnp.exp(-1j * jnp.pi * (2 * k + 1) / (4 * n)).reshape(shape)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n)
    F = jnp.fft.fft(jnp.pad(x * pre, pad), axis=axis)
    return (2 * jnp.real(post * jnp.take(F, k, axis=axis))).astype(x.dtype)


def _dct1(x, axis):
    n = x.shape[axis]
    inner = jnp.take(x, jnp.arange(n - 2, 0, -1), axis=axis)
    ext = jnp.concatenate([x, inner], axis=axis)
    F = jnp.fft.fft(ext, axis=axis)
    return jnp.real(jnp.take(F, jnp.arange(n), axis=axis)).astype(x.dtype)


def dct(a, b=None, type=2, axis=-1, **kw):
    """scipy.fftpack-compatible DCT.  ``b`` (out param) accepted and ignored."""
    kw.pop("threads", None)
    kw.pop("planner_effort", None)
    axis = axis % a.ndim
    if type == 1:
        return _dct1(a, axis)
    if type == 2:
        return _dct2(a, axis)
    if type == 3:
        return _dct3(a, axis)
    if type == 4:
        return _dct4(a, axis)
    raise NotImplementedError(f"dct type {type} not implemented (types 1-4 available)")


def idct(a, b=None, type=2, axis=-1, **kw):
    """Inverse DCT with scipy.fftpack's unnormalised pairing: idct(·,2) is the
    raw DCT-III (so ``idct(dct(x)) == 2N·x``), idct(·,3) the raw DCT-II."""
    kw.pop("threads", None)
    kw.pop("planner_effort", None)
    axis = axis % a.ndim
    if type == 2:
        return _dct3(a, axis)
    if type == 3:
        return _dct2(a, axis)
    if type == 1:
        # scipy.fftpack pairing: idct(·,1) is the unnormalised DCT-I itself
        # (idct(dct(x,1),1) == 2(N-1)·x).
        return _dct1(a, axis)
    if type == 4:
        # DCT-IV is self-inverse up to 2N: idct(dct(x,4),4) == 2N·x.
        return _dct4(a, axis)
    raise NotImplementedError(f"idct type {type} not implemented")
