"""Field checkpoint I/O — save/restore distributed spectral or physical fields.

Reference stance (SURVEY.md §5): mpiFFT4py itself is stateless; its consumer
(spectralDNS) layered HDF5 field I/O on top.  This module is the minimal
equivalent for DNS runs: gather → compressed ``.npz`` on save,
``device_put`` back onto the transform's sharding on load.  Double-word
fields are stored as float64.

For multi-process runs, every process calls these with the same path on a shared
filesystem; only process 0 writes (the usual JAX convention).
"""

from __future__ import annotations

import numpy as np

import jax

__all__ = ["save_field", "load_field", "save_state", "load_state"]


def _to_host(FFT, x):
    if hasattr(FFT, "gather_dd"):
        return FFT.gather_dd(x)  # handles DD/DDComplex and plain arrays
    return FFT.gather(x)


def _sharding_for(FFT, ndim: int, spectral: bool):
    """FFT's real/spectral sharding, None-padded for leading (component) dims."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = tuple(FFT.complex_spec() if spectral else FFT.real_spec())
    extra = ndim - len(spec)
    return NamedSharding(FFT.mesh, P(*((None,) * extra + spec)))


def _place(FFT, host, spectral: bool):
    sh = _sharding_for(FFT, host.ndim, spectral)
    if FFT.policy.path == "doubleword":
        from ..ops.doubledouble import DD, DDComplex
        d = (DDComplex.from_c128(np.asarray(host, np.complex128)) if spectral
             else DD.from_f64(np.asarray(host, np.float64)))
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)
    from .transfer import device_put as _dp
    return _dp(host, FFT.complex if spectral else FFT.float, sh)


def save_field(path: str, FFT, x, name: str = "field") -> None:
    """Gather a (possibly sharded / dd) field and save as compressed .npz."""
    host = _to_host(FFT, x)
    if jax.process_index() == 0:
        np.savez_compressed(path, **{name: host},
                            N=np.asarray(FFT.N), precision=FFT.policy.precision)


def load_field(path: str, FFT, name: str = "field", space: str = "auto"):
    """Load a field saved by save_field and place it on FFT's sharding.

    ``space``: "real" | "spectral" | "auto" (inferred from the array dtype —
    complex ⇒ spectral).  Returns a sharded jax.Array (or DD/DDComplex pytree
    under the doubleword policy).
    """
    with np.load(path) as z:
        host = z[name]
        n_saved = z["N"]
    if not np.array_equal(n_saved, np.asarray(FFT.N)):
        raise ValueError(f"checkpoint grid {tuple(n_saved)} != transform grid "
                         f"{tuple(FFT.N)}")
    spectral = (np.iscomplexobj(host) if space == "auto"
                else space == "spectral")
    return _place(FFT, host, spectral)


def save_state(path: str, FFT, U_hat, step: int = 0, t: float = 0.0,
               **extra) -> None:
    """DNS checkpoint: a (ncomp,)+spectral stack plus scalar run metadata."""
    host = _to_host(FFT, U_hat)
    if jax.process_index() == 0:
        np.savez_compressed(path, U_hat=host, step=step, t=t,
                            N=np.asarray(FFT.N),
                            precision=FFT.policy.precision, **extra)


def load_state(path: str, FFT):
    """Returns (state sharded, dict of metadata)."""
    with np.load(path) as z:
        host = z["U_hat"]
        meta = {k: z[k] for k in z.files if k != "U_hat"}
    if not np.array_equal(meta["N"], np.asarray(FFT.N)):
        raise ValueError(f"checkpoint grid {tuple(meta['N'])} != transform "
                         f"grid {tuple(FFT.N)}")
    return _place(FFT, host, spectral=True), meta
