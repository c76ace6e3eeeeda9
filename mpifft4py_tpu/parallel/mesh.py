"""Device-mesh construction — the JAX "communicator".

Reference analog: mpiFFT4py takes a caller-supplied ``mpi4py`` communicator and,
for pencil, ``Comm.Split``s it into two orthogonal sub-communicators
(SURVEY.md §2.4).  The JAX equivalent is a ``jax.sharding.Mesh``:

* slab/line  →  1D mesh, axis name ``"p"``     (the reference's whole comm)
* pencil     →  2D mesh, axis names ``("p1", "p2")``  (the two sub-comms; the
  orthogonal groups the reference builds with Comm.Split are exactly what a 2D
  mesh's named axes give for free — a grouped ``lax.all_to_all`` over one axis
  name is an Alltoall inside one sub-communicator).

The ``comm`` argument of the R2C/C2C constructors accepts:
  * ``None``                      — all addressable devices,
  * a ``jax.sharding.Mesh``       — used as-is (must have the right rank),
  * an int ``P``                  — first ``P`` devices,
  * a sequence of jax devices     — exactly those devices.

The mesh follows the decomposition alone: the cards of one host are joined
all to all (four H100s over NVLink), so no device order is faster than
another and no axis needs to sit on a particular link.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

import jax
from jax.sharding import Mesh

AXIS = "p"          # 1D decompositions (slab, line)
AXIS1 = "p1"        # pencil: first mesh axis (splits real axis 0)
AXIS2 = "p2"        # pencil: second mesh axis (splits real axis 1)

CommLike = Union[None, Mesh, int, Sequence]


def _device_list(comm: CommLike):
    if comm is None:
        return list(jax.devices())
    if isinstance(comm, int):
        devs = list(jax.devices())
        if comm > len(devs):
            raise ValueError(f"requested {comm} devices, only {len(devs)} available")
        return devs[:comm]
    return list(comm)


def slab_mesh(comm: CommLike = None) -> Mesh:
    """1D mesh over ``comm`` with axis name ``"p"`` (slab/line decompositions)."""
    if isinstance(comm, Mesh):
        if len(comm.axis_names) != 1:
            raise ValueError(f"slab/line need a 1D mesh, got axes {comm.axis_names}")
        return comm
    devs = _device_list(comm)
    return Mesh(np.asarray(devs), (AXIS,))


def pencil_mesh(comm: CommLike = None, P1: Optional[int] = None) -> Mesh:
    """2D mesh over ``comm`` with axes ``("p1", "p2")``.

    ``P1`` mirrors the reference pencil constructor kwarg: the size of the first
    process-grid dimension.  Default: the most square factorization, with
    P1 <= P2 (the reference's default grid).
    """
    if isinstance(comm, Mesh):
        if len(comm.axis_names) != 2:
            raise ValueError(f"pencil needs a 2D mesh, got axes {comm.axis_names}")
        return comm
    devs = _device_list(comm)
    P = len(devs)
    if P1 is None:
        P1 = int(np.sqrt(P))
        while P % P1 != 0:
            P1 -= 1
    if P % P1 != 0:
        raise ValueError(f"P1={P1} does not divide device count {P}")
    P2 = P // P1
    if len(devs) > 1:
        try:
            from jax.experimental import mesh_utils

            arr = mesh_utils.create_device_mesh((P1, P2), devices=devs)
        except Exception:
            arr = np.asarray(devs).reshape(P1, P2)
    else:
        arr = np.asarray(devs).reshape(P1, P2)
    return Mesh(arr, (AXIS1, AXIS2))


def mesh_size(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))


def check_divisible(N, P: int, what: str):
    """Reference keeps hard N % P == 0 asserts (SURVEY.md §7 'hard parts'); so do we."""
    if int(N) % int(P) != 0:
        raise ValueError(f"{what}: size {N} not divisible by {P} devices")
