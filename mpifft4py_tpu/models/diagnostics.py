"""Spectral diagnostics for DNS runs: shell-binned energy spectra, dissipation.

The spectralDNS consumer pattern: E(k) shell sums over the r2c spectrum with
Hermitian weights (interior k2 modes count twice), computed on device and
sharding-transparently (segment_sum over shell indices).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _hermitian_weights(FFT):
    """Weights over the last spectral axis.

    r2c (halved) layout: 1 for k=0 and Nyquist, 2 interior, 0 for alignment
    padding.  c2c (full last axis, e.g. slab.C2C): every mode is stored
    explicitly, so unit weights — the r2c doubling there would double-count
    everything and zero the upper half.
    """
    nfp = FFT.global_complex_shape()[-1]
    n_last = int(FFT.N[-1])
    # c2c transforms (slab.C2C) have no Nf attribute — full last axis, unit
    # weights.  (Storage width nfp is NOT a valid discriminator: pencil/line
    # alignment padding can make Nfp == N while the layout is still r2c.)
    nf = getattr(FFT, "Nf", None)
    if nf is None:
        return jnp.ones((nfp,), jnp.float32)
    k = np.arange(nfp)
    w = np.where((k == 0) | (k == n_last // 2), 1.0, 2.0)
    w[k >= nf] = 0.0
    return jnp.asarray(w, jnp.float32)


def energy_spectrum(FFT, U_hat) -> np.ndarray:
    """Shell-binned kinetic-energy spectrum E(k), k = 0..kmax.

    ``U_hat``: (ncomp,) + global_complex_shape() spectral velocity.
    Returns a host numpy array; Σ E(k) = mean KE (Parseval-consistent).
    """
    K = FFT.get_local_wavenumbermesh()          # integer wavenumbers, sharded
    kmax = int(np.max(FFT.N) // 2)
    w = _hermitian_weights(FFT)
    ntot = float(np.prod([int(n) for n in FFT.N]))

    def spec(U_hat, K):
        kmag = jnp.sqrt(jnp.sum(K * K, axis=0))
        shell = jnp.clip(jnp.round(kmag).astype(jnp.int32), 0, kmax)
        e = 0.5 * jnp.sum(jnp.abs(U_hat) ** 2, axis=0) * w / (ntot * ntot)
        return jax.ops.segment_sum(e.ravel(), shell.ravel(), num_segments=kmax + 1)

    return np.asarray(jax.jit(spec)(U_hat, K))


def dissipation(FFT, U_hat, nu: float) -> float:
    """ε = 2ν Σ k² E(k) (physical wavenumbers)."""
    K = FFT.get_scaled_local_wavenumbermesh()
    w = _hermitian_weights(FFT)
    ntot = float(np.prod([int(n) for n in FFT.N]))

    def eps(U_hat, K):
        k2 = jnp.sum(K * K, axis=0)
        e = jnp.sum(jnp.abs(U_hat) ** 2, axis=0) * w / (ntot * ntot)
        return nu * jnp.sum(k2 * e)

    return float(jax.jit(eps)(U_hat, K))
