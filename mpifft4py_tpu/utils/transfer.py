"""Host↔device transfer helpers used by the transform classes and ``FFT.gather``.

Thin wrappers over ``np.asarray`` / ``jax.device_put`` / ``jnp.zeros`` that
fix the dtype and sharding in one call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["to_numpy", "device_put", "zeros"]


def zeros(shape, dtype, sharding=None) -> jax.Array:
    """Zeros of ``shape``/``dtype``, created directly on ``sharding`` when
    given (no full-size copy on one device first)."""
    return jnp.zeros(shape, dtype, device=sharding)


def to_numpy(x) -> np.ndarray:
    """Fetch a (possibly sharded) jax array to a host numpy array."""
    return np.asarray(x)


def device_put(a, dtype, sharding: Optional[jax.sharding.Sharding] = None) -> jax.Array:
    """Place a host (or device) array with the given dtype and sharding."""
    dtype = np.dtype(dtype)
    if isinstance(a, jax.Array):
        return jax.device_put(a.astype(dtype), sharding)
    return jax.device_put(np.asarray(a, dtype=dtype), sharding)
