"""Precision policy and scratch-array compatibility layer.

Re-design of the reference's ``mpiFFT4py/mpibase.py`` (reference mount was
empty at build time — see SURVEY.md §0; parity target is SURVEY.md §2.1 component #2):

* ``datatypes(precision)`` — maps ``"single"``/``"double"`` to a (float, complex,
  collective) dtype triple.  The reference's third element is an MPI complex datatype;
  here the collective tier is XLA's, which is dtype-transparent, so the third element
  is simply the complex dtype the collectives move.
* ``work_arrays`` — the reference caches scratch numpy buffers keyed by
  ``(shape, dtype, index)`` because FFTW works in-place into user buffers.  Under
  XLA there is no user-managed scratch: buffer assignment is owned by the compiler,
  and transforms are pure functions.  ``work_arrays`` survives as a thin
  compatibility dict so consumer code written against the reference keeps running;
  arrays it hands out are ordinary ``jax.numpy`` arrays.

Execution paths for ``"double"``:

* ``native``     — real float64/complex128 whenever x64 is enabled (the CPU,
  and NVIDIA GPUs through cuFFT's Z2Z/D2Z).
* ``doubleword`` — double-word (two-float32) emulation, implemented in
  ``mpifft4py_tpu.ops.doubledouble`` (error-free two-sum/two-prod transforms);
  chosen by ``fp64_mode="doubleword"`` or when x64 is off.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Tuple

import numpy as np


def _x64_enabled() -> bool:
    import jax

    return bool(jax.config.jax_enable_x64)


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Resolved numeric policy for one transform object.

    Attributes:
      precision: the user-requested string, "single" or "double".
      float: numpy float dtype used for physical-space fields.
      complex: numpy complex dtype used for spectral-space fields.
      path: "native" (hardware dtype) or "doubleword" (two-float32 emulation).
    """

    precision: str
    float: np.dtype
    complex: np.dtype
    path: str

    @property
    def eps(self) -> float:
        if self.path == "doubleword":
            return 2.0 ** -48  # double-float32 unit roundoff
        return float(np.finfo(self.float).eps)


def resolve_precision(precision: str, fp64_mode: str = "auto") -> DTypePolicy:
    """Resolve a precision string to concrete dtypes + execution path.

    Args:
      precision: "single" | "double".
      fp64_mode: "auto" (native f64 when ``jax_enable_x64`` is on, on any
        backend — the CPU, or a GPU through cuFFT's Z2Z/D2Z — else
        double-word emulation), "native" (force f64 — requires x64), or
        "doubleword" (force the two-float32 emulation path).  The doubleword
        path relies on error-free transforms that FMA contraction breaks;
        its accuracy on a given backend is measured, not assumed.
    """
    if precision == "single":
        return DTypePolicy("single", np.dtype(np.float32), np.dtype(np.complex64), "native")
    if precision != "double":
        raise ValueError(f"precision must be 'single' or 'double', got {precision!r}")

    if fp64_mode == "native":
        if not _x64_enabled():
            raise ValueError(
                "fp64_mode='native' requires jax_enable_x64 — without it arrays "
                "silently degrade to float32. Enable it with "
                "jax.config.update('jax_enable_x64', True), or use "
                "fp64_mode='doubleword'.")
        return DTypePolicy("double", np.dtype(np.float64), np.dtype(np.complex128), "native")
    if fp64_mode == "doubleword":
        return DTypePolicy("double", np.dtype(np.float32), np.dtype(np.complex64), "doubleword")
    if fp64_mode != "auto":
        raise ValueError(f"fp64_mode must be 'auto'|'native'|'doubleword', got {fp64_mode!r}")

    if _x64_enabled():
        return DTypePolicy("double", np.dtype(np.float64), np.dtype(np.complex128), "native")
    # x64 disabled: float64 arrays cannot exist, so emulate with float32 pairs.
    return DTypePolicy("double", np.dtype(np.float32), np.dtype(np.complex64), "doubleword")


def datatypes(precision: str) -> Tuple[np.dtype, np.dtype, np.dtype]:
    """Reference-compatible dtype triple.

    Reference (mpiFFT4py/mpibase.py) returns (float, complex, MPI-complex-type).
    The XLA collective tier has no separate datatype handle, so the third slot is
    the complex dtype itself — it is what the all-to-alls move.
    """
    pol = resolve_precision(precision)
    return (pol.float, pol.complex, pol.complex)


class work_arrays(dict):
    """Cached scratch arrays, API-compatible with mpiFFT4py's ``work_arrays``.

    Reference semantics (mpiFFT4py/mpibase.py): a dict whose ``__missing__``
    lazily allocates an array.  Keys come in two flavors:

    * ``(shape_tuple, dtype, index)`` and optionally a 4th bool "fill with zeros";
    * ``(prototype_array, index)`` — shape/dtype taken from the prototype.

    Under XLA these buffers are never *needed* (transforms are functional and the
    compiler owns scratch), but the consumer-facing convention ``fu =
    FFT.fftn(u, fu)`` passes arrays that originate here, so we keep the
    container.  Arrays are zero-filled jax arrays (functional semantics make
    "uninitialised" meaningless).
    """

    @staticmethod
    def _normalize(key):
        # Array prototypes are unhashable; fold them to (shape, dtype, rest...).
        first = key[0]
        if hasattr(first, "shape") and hasattr(first, "dtype"):
            return (tuple(first.shape), np.dtype(first.dtype)) + tuple(key[1:])
        return (tuple(first), np.dtype(key[1])) + tuple(key[2:])

    def __getitem__(self, key):
        return super().__getitem__(self._normalize(key))

    def __missing__(self, key):
        from .utils.transfer import zeros

        a = zeros(key[0], key[1])
        self[key] = a
        return a


def planner_effort_default():
    """Reference compat: FFTW planner-effort mapping.

    FFTW plan quality maps onto the XLA compilation cache: the first jit
    trace/compile is the "plan", cached thereafter.  Kept so constructor kwargs
    from reference-era code (``planner_effort=defaultdict(...)``) type-check.
    """
    return defaultdict(lambda: "FFTW_MEASURE")
