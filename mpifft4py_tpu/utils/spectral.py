"""Spectral-space padding/truncation and wavenumber helpers.

Re-design of the reference's 3/2-rule "copy_to_padded / copy_from_padded"
helpers and wavenumber-mesh builders (reference: mpiFFT4py/slab.py — mount empty at
build time, parity target SURVEY.md §3.3).

All functions are pure ``jnp`` ops with static shapes, safe inside
``jit``/``shard_map``.

Nyquist handling (exactness): when zero-padding a length-N *full* (c2c-layout)
spectral axis to length M, the single N-grid Nyquist coefficient a = c[N/2]
aliases the +N/2 and −N/2 modes.  We split it — c_pad[N/2] = c_pad[M−N/2] = a/2 —
which (i) keeps the padded spectrum Hermitian-symmetric for real fields, and
(ii) makes truncation (which *sums* the two positions) an exact inverse, so
``fftn(ifftn(fu, dealias="3/2-rule"), dealias="3/2-rule") == fu`` to roundoff.
For the *half* (rfft-layout) last axis the Nyquist c[Nf−1] is likewise halved on
padding and doubled on truncation (it moves from weight-1 to weight-2 in the
padded reconstruction).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp

__all__ = [
    "pad_full_axis", "trunc_full_axis", "pad_half_axis", "trunc_half_axis",
    "wavenumbers_full", "wavenumbers_half", "dealias_cutoffs", "regrid",
]


def _slc(ndim: int, axis: int, start, stop) -> Tuple[slice, ...]:
    s = [slice(None)] * ndim
    s[axis] = slice(start, stop)
    return tuple(s)


def pad_full_axis(x: jnp.ndarray, axis: int, M: int) -> jnp.ndarray:
    """Zero-pad a full (fft-layout) spectral axis from N to M, splitting Nyquist."""
    N = x.shape[axis]
    if M == N:
        return x
    assert N % 2 == 0, f"padded transforms need even sizes, got {N}"
    assert M > N
    h = N // 2
    nd = x.ndim
    pos = x[_slc(nd, axis, 0, h)]
    ny = x[_slc(nd, axis, h, h + 1)] * 0.5
    neg = x[_slc(nd, axis, h + 1, N)]
    zshape = list(x.shape)
    zshape[axis] = M - N - 1
    zeros = jnp.zeros(zshape, dtype=x.dtype)
    return jnp.concatenate([pos, ny, zeros, ny, neg], axis=axis)


def trunc_full_axis(x: jnp.ndarray, axis: int, N: int) -> jnp.ndarray:
    """Truncate a full spectral axis from M back to N, summing the split Nyquist."""
    M = x.shape[axis]
    if M == N:
        return x
    h = N // 2
    nd = x.ndim
    pos = x[_slc(nd, axis, 0, h)]
    ny = x[_slc(nd, axis, h, h + 1)] + x[_slc(nd, axis, M - h, M - h + 1)]
    neg = x[_slc(nd, axis, M - h + 1, M)]
    return jnp.concatenate([pos, ny, neg], axis=axis)


def pad_half_axis(x: jnp.ndarray, axis: int, Mf: int, Nf: int | None = None) -> jnp.ndarray:
    """Zero-pad a half (rfft-layout) spectral axis from Nf to Mf, halving Nyquist.

    ``Nf`` lets callers pad arrays whose axis already carries alignment padding
    (pencil's Nfp): modes at index >= Nf are dropped (they are structural zeros).
    """
    nd = x.ndim
    if Nf is None:
        Nf = x.shape[axis]
    if Mf == Nf and Nf == x.shape[axis]:
        return x
    body = x[_slc(nd, axis, 0, Nf - 1)]
    ny = x[_slc(nd, axis, Nf - 1, Nf)] * 0.5
    zshape = list(x.shape)
    zshape[axis] = Mf - Nf
    zeros = jnp.zeros(zshape, dtype=x.dtype)
    return jnp.concatenate([body, ny, zeros], axis=axis)


def trunc_half_axis(x: jnp.ndarray, axis: int, Nf: int) -> jnp.ndarray:
    """Truncate a half spectral axis from Mf back to Nf, doubling Nyquist.

    Doubling equals the true alias sum ĉ[k,N/2] + conj(ĉ[-k,N/2]) only when
    the Nyquist plane is self-conjugate — exact for round trips; a general
    dealiased product keeps an anti-Hermitian residual there.  The R2C
    forwards therefore finish their 3/2-rule path with
    ``flip_conj_plane``-based symmetrization (exact for products, no-op for
    round trips) once every axis is transformed.
    """
    nd = x.ndim
    if x.shape[axis] == Nf:
        return x
    body = x[_slc(nd, axis, 0, Nf - 1)]
    ny = x[_slc(nd, axis, Nf - 1, Nf)] * 2.0
    return jnp.concatenate([body, ny], axis=axis)


def flip_conj_plane(q: jnp.ndarray, axes) -> jnp.ndarray:
    """conj(Q(−k)) over full fft-layout ``axes`` (index j → (n−j) mod n)."""
    axes = tuple(axes)
    return jnp.conj(jnp.roll(jnp.flip(q, axis=axes), (1,) * len(axes),
                             axis=axes))


# ---- wavenumbers ------------------------------------------------------------

def wavenumbers_full(n: int, dtype=np.float64) -> np.ndarray:
    """Integer wavenumbers in fft layout: [0..n/2-1, -n/2..-1] (numpy fftfreq*n)."""
    return np.fft.fftfreq(n, 1.0 / n).astype(dtype)


def wavenumbers_half(nf: int, dtype=np.float64) -> np.ndarray:
    """Integer wavenumbers in rfft layout: [0..nf-1] (covers alignment padding too:
    padded entries get k >= Nf which every dealias cutoff removes)."""
    return np.arange(nf, dtype=dtype)


def dealias_cutoffs(N: Sequence[int]) -> tuple:
    """2/3-rule cutoffs per axis: keep |k_i| < (2/3)·(N_i/2).

    Python floats (weakly typed in JAX), so comparing a float32 wavenumber
    against them stays float32 when x64 is on."""
    return tuple((2.0 / 3.0) * (int(n) // 2) for n in N)


def regrid(fu, N_new, N_old=None):
    """Spectral resampling of an rfftn-layout spectrum to a new grid size.

    ``fu`` has shape (…, n0, n1, nf) (numpy ``rfftn`` convention over the
    last three axes, unnormalised); the result is the spectrum of the SAME
    continuum trigonometric polynomial sampled on the ``N_new`` grid
    (band-limited / exact trigonometric interpolation when refining; spectral
    truncation when coarsening).  The unnormalised-DFT amplitude scales with
    the point count, so shared modes are multiplied by ∏N_new/∏N_old —
    ``irfftn(regrid(rfftn(u), M))`` IS u's trig interpolant on the M grid.

    ``N_old`` is the ORIGINAL grid (int[3]).  Required when the last axis
    carries alignment padding (pencil gathers: width Nfp ≥ Nf) — without it
    the old grid is inferred as ``2·(nf−1)``, which is only correct for
    exact-rfftn widths; padded columns are sliced off first.

    Backend-dispatching: numpy in → numpy out (no device transfer — the
    checkpoint→regrid→continue workflow runs on gathered host arrays),
    jax in → jax ops.
    """
    xp = np if isinstance(fu, np.ndarray) else jnp
    N_new = [int(n) for n in N_new]
    assert len(N_new) == 3 and all(n % 2 == 0 for n in N_new), N_new
    nd = fu.ndim
    if N_old is None:
        # an exact rfftn width of an even grid is N/2+1, always ODD — an even
        # last-axis width means alignment padding (pencil gather Nfp > Nf)
        # would be silently reinterpreted as spectrum
        if fu.shape[nd - 1] % 2 == 0:
            raise ValueError(
                f"last-axis width {fu.shape[nd - 1]} is not an exact rfftn "
                "layout (even); pass N_old= so alignment padding can be "
                "sliced off")
        n_old = [fu.shape[nd - 3], fu.shape[nd - 2],
                 2 * (fu.shape[nd - 1] - 1)]
    else:
        n_old = [int(n) for n in N_old]
        assert fu.shape[nd - 3] == n_old[0] and fu.shape[nd - 2] == n_old[1]
        fu = fu[..., :n_old[2] // 2 + 1]          # drop alignment padding

    def slc(axis, start, stop):
        s = [slice(None)] * nd
        s[axis] = slice(start, stop)
        return tuple(s)

    def pad_full(x, axis, M):
        Nax = x.shape[axis]
        if M == Nax:
            return x
        hh = Nax // 2
        zshape = list(x.shape)
        zshape[axis] = M - Nax - 1
        ny = x[slc(axis, hh, hh + 1)] * 0.5
        return xp.concatenate(
            [x[slc(axis, 0, hh)], ny, xp.zeros(zshape, dtype=x.dtype), ny,
             x[slc(axis, hh + 1, Nax)]], axis=axis)

    def trunc_full(x, axis, Nn):
        M = x.shape[axis]
        if M == Nn:
            return x
        hh = Nn // 2
        ny = x[slc(axis, hh, hh + 1)] + x[slc(axis, M - hh, M - hh + 1)]
        return xp.concatenate(
            [x[slc(axis, 0, hh)], ny, x[slc(axis, M - hh + 1, M)]], axis=axis)

    x = fu
    for i, ax in enumerate((nd - 3, nd - 2)):
        if N_new[i] > n_old[i]:
            x = pad_full(x, ax, N_new[i])
        elif N_new[i] < n_old[i]:
            x = trunc_full(x, ax, N_new[i])
    nf_new = N_new[2] // 2 + 1
    nf_old = n_old[2] // 2 + 1
    if N_new[2] > n_old[2]:
        zshape = list(x.shape)
        zshape[nd - 1] = nf_new - nf_old
        x = xp.concatenate(
            [x[..., :nf_old - 1], x[..., nf_old - 1:nf_old] * 0.5,
             xp.zeros(zshape, dtype=x.dtype)], axis=-1)
    elif N_new[2] < n_old[2]:
        x = xp.concatenate(
            [x[..., :nf_new - 1], x[..., nf_new - 1:nf_new] * 2.0], axis=-1)
        # the truncated z-Nyquist plane keeps only the self-conjugate part
        q = x[..., -1]
        axes = (nd - 3, nd - 2)
        f = xp.conj(xp.roll(xp.flip(q, axis=axes), (1, 1), axis=axes))
        x = xp.concatenate([x[..., :-1], (0.5 * (q + f))[..., None]], axis=-1)
    scale = np.prod(N_new, dtype=np.float64) / np.prod(n_old, dtype=np.float64)
    return x * x.dtype.type(scale)
