"""Debug mode & self-validation — the aux-subsystem tier (SURVEY.md §5).

The reference has no sanitizers; correctness-by-construction (blocking
collectives, single-threaded control flow) carries over to the pure-functional
SPMD design here.  What we add on top:

* ``debug_mode()`` — context manager enabling NaN/Inf trapping inside jitted
  transforms (``jax_debug_nans``/``jax_debug_infs``), the closest analog of a
  race/sanitizer pass for this execution model.
* ``validate(FFT)`` — on-device self-check of a transform object: round-trip
  identity, linearity, Parseval's theorem, and (for r2c) Hermitian-symmetry
  consistency of the forward output.  Returns a dict of residuals; every entry
  should be at the dtype's roundoff scale.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Trap NaN/Inf production inside jitted transform pipelines."""
    old_n = jax.config.jax_debug_nans
    old_i = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_n)
        jax.config.update("jax_debug_infs", old_i)


def validate(FFT, seed: int = 0) -> Dict[str, float]:
    """Self-check a slab/pencil/line transform object on its own devices.

    Residuals returned (all should be ~dtype roundoff):
      roundtrip   max |ifft(fft(u)) - u|
      linearity   max |fft(a·u + v) - (a·fft(u) + fft(v))|  (relative)
      parseval    |Σ|u|² - Σ w|û|²/Ntot| / Σ|u|²  (w = Hermitian weights)
    """
    rng = np.random.default_rng(seed)
    is2d = FFT.ndim == 2
    shape = FFT.global_real_shape()
    u_np = rng.standard_normal(shape)
    v_np = rng.standard_normal(shape)
    fwd_name = "fft2" if is2d else "fftn"
    bwd_name = "ifft2" if is2d else "ifftn"
    fwd = getattr(FFT, fwd_name)
    bwd = getattr(FFT, bwd_name)

    u = FFT.shard_real(u_np.astype(FFT.float))
    v = FFT.shard_real(v_np.astype(FFT.float))
    fu = fwd(u)
    fv = fwd(v)
    ub = bwd(fu)

    rt = float(jax.jit(lambda a, b: jnp.max(jnp.abs(a - b)))(ub, u))

    a = FFT.float.type(1.7)
    flin = fwd(jax.jit(lambda x, y: a * x + y)(u, v))
    lin = float(jax.jit(
        lambda f1, f2, f3: jnp.max(jnp.abs(f1 - (a * f2 + f3)))
        / jnp.maximum(jnp.max(jnp.abs(f1)), 1e-30))(flin, fu, fv))

    # Parseval with rfft Hermitian weights on the last axis (k=0 and Nyquist
    # count once; interior modes twice).  Alignment-padded columns are zero.
    nf_valid = getattr(FFT, "Nf", None)
    n_last = int(FFT.N[-1])
    ntot = float(np.prod([int(n) for n in FFT.N]))

    def parseval(u, fu):
        pu = jnp.sum(u.astype(jnp.float32) ** 2)
        mag = jnp.abs(fu).astype(jnp.float32) ** 2
        k = jnp.arange(fu.shape[-1])
        if nf_valid is not None and nf_valid != n_last:  # r2c layout
            w = jnp.where((k == 0) | (k == n_last // 2), 1.0, 2.0)
            w = jnp.where(k >= nf_valid, 0.0, w)
            mag = mag * w
        ps = jnp.sum(mag) / ntot
        return jnp.abs(pu - ps) / pu

    par = float(jax.jit(parseval)(u, fu))
    return {"roundtrip": rt, "linearity": lin, "parseval": par}
