"""mpifft4py_tpu — distributed FFTs in JAX for pseudo-spectral solvers.

A ground-up JAX/XLA re-design with the capabilities of
``spectralDNS/mpiFFT4py`` (parallel 2D/3D real↔complex and complex↔complex FFTs
with slab/pencil/line domain decompositions and 2/3- & 3/2-rule dealiasing).
See SURVEY.md for the layer map and parity inventory.

Public surface (reference parity — mpiFFT4py/__init__.py):

    from mpifft4py_tpu.slab import R2C, C2C     # 3D, 1D mesh decomposition
    from mpifft4py_tpu.pencil import R2C        # 3D, 2D mesh decomposition
    from mpifft4py_tpu.line import R2C          # 2D, 1D mesh decomposition
    from mpifft4py_tpu import work_arrays, datatypes
    from mpifft4py_tpu import fft, ifft, rfftn, irfftn, dct, ...  # serial tier

Additions to the reference API: every transform object exposes ``real_sharding()`` /
``complex_sharding()`` / ``forward_fn()`` / ``backward_fn()`` so transforms
compose into larger jitted SPMD programs over a ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"

from .mpibase import datatypes, work_arrays, resolve_precision, DTypePolicy  # noqa: F401
from .utils.transfer import to_numpy, device_put  # noqa: F401
from .utils.io import save_field, load_field, save_state, load_state  # noqa: F401
from .serialFFT import (  # noqa: F401
    fft, ifft, fft2, ifft2, fftn, ifftn,
    rfft, irfft, rfft2, irfft2, rfftn, irfftn,
    dct, idct,
)


def empty(shape, dtype=float):
    """Reference-parity allocation helper (pyfftw-aligned empty → device zeros:
    'uninitialised' is meaningless under functional XLA semantics)."""
    from .utils.transfer import zeros as _zeros

    return _zeros(tuple(shape), dtype)


def zeros(shape, dtype=float):
    from .utils.transfer import zeros as _zeros

    return _zeros(tuple(shape), dtype)
