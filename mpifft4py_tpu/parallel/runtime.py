"""Multi-process runtime scaffolding.

Reference analog: mpiFFT4py never calls ``MPI_Init`` itself — ``mpi4py`` does
on import, and the caller passes a communicator in (SURVEY.md §2.4).  The JAX
equivalent of "the job launcher owns process bootstrap" is
``jax.distributed.initialize``: in a multi-process job each process calls it
once before touching devices, after which ``jax.devices()`` is the *global*
device list and every ``Mesh`` built from it spans all processes.

This module provides:

* ``initialize(...)`` — thin, idempotent wrapper over
  ``jax.distributed.initialize`` (no-op under a single process or when the
  runtime is already initialised), so user scripts run unchanged on one
  process or many.
* ``hybrid_mesh(mesh_shape, axis_names, ...)`` — compose an outer axis that
  spans granules (hosts, or slices where the platform reports them) with
  inner axes inside one granule, so collectives along the inner names never
  leave a host.  Built on ``mesh_utils.create_hybrid_device_mesh`` with a
  pure-numpy fallback so the composition logic is unit-testable with fake
  device objects.

Usage with one process per GPU host (a cluster launcher gives no
auto-detection, so pass the coordinator explicitly)::

    from mpifft4py_tpu.parallel import runtime
    runtime.initialize("host0:12345", num_processes=2, process_id=rank)
    FFT = pencil.R2C(N, L, None, "single")    # comm=None -> all global devices

The decomposition classes themselves are unchanged: single-controller SPMD
means the transform program is identical; only device discovery differs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

__all__ = ["initialize", "is_initialized", "hybrid_mesh"]

_initialized = False


def is_initialized() -> bool:
    """True if this process already joined a multi-process JAX runtime."""
    return _initialized


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kw) -> None:
    """Join the multi-process runtime (idempotent; no-op for 1 process).

    All arguments optional: where the cluster environment provides them
    (``JAX_COORDINATOR_ADDRESS`` and friends, or a scheduler JAX can
    auto-detect) JAX reads them itself, matching how ``mpirun`` fed
    ``MPI_Init`` for the reference; otherwise pass them explicitly.  Call
    before any other JAX API.  Under a single-process launch (no coordinator
    information at all) this is a no-op so scripts stay portable.
    """
    global _initialized
    if _initialized:
        return
    import os
    env_driven = any(os.environ.get(k) for k in
                     ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                      "MEGASCALE_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not env_driven:
        # Single-process or auto-detected launch: initialize only when JAX
        # can auto-detect a real multi-process cluster; otherwise stay a
        # no-op so the same script runs on one device.
        try:
            jax.distributed.initialize()
            _initialized = True
        except Exception:
            pass
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    _initialized = True


def _granule_key(dev) -> Tuple:
    """Group devices into granules: ``slice_index`` where the platform
    reports one, else ``process_index`` (GPU and CPU devices carry no
    ``slice_index``, so one process — one host — is one granule), then host
    id attributes on fakes.
    """
    for attr in ("slice_index", "process_index", "host_id"):
        v = getattr(dev, attr, None)
        if v is not None:
            return (attr, int(v))
    return ("flat", 0)


def hybrid_mesh(ici_shape: Sequence[int], axis_names: Sequence[str],
                dcn_axis: str = "dcn", devices=None) -> Mesh:
    """Mesh with an outer axis across granules and inner axes within one.

    ``ici_shape``/``axis_names`` describe the per-granule mesh; the returned
    mesh has shape ``(n_granules,) + ici_shape`` with axis names
    ``(dcn_axis,) + axis_names``.  Collectives over the inner names stay
    inside one granule (one host's NVLink-joined cards); only ``dcn_axis``
    crosses granules over the network.  A pencil transform maps its two
    all-to-all groups onto inner names and uses ``dcn_axis`` for batch /
    ensemble parallelism.

    With one granule the outer axis has size 1 (costless).  Granule membership
    comes from device attributes (``slice_index``/``process_index``), so the
    composition is testable with fake device lists.
    """
    devs = list(jax.devices()) if devices is None else list(devices)
    granules: dict = {}
    for d in devs:
        granules.setdefault(_granule_key(d), []).append(d)
    groups = [granules[k] for k in sorted(granules)]
    per = int(np.prod(ici_shape))
    for g in groups:
        if len(g) != per:
            raise ValueError(
                f"each granule must have exactly prod(ici_shape)={per} "
                f"devices; got granule sizes {[len(x) for x in groups]}")
    want = (len(groups),) + tuple(ici_shape)
    try:  # the platform's own device ordering, when it has one
        # create_hybrid_device_mesh takes same-rank shapes whose elementwise
        # product is the result shape: per-granule (1, *ici) × across-granule
        # (G, 1, …) → (G, *ici) with the outer axis leading.
        from jax.experimental import mesh_utils
        arr = mesh_utils.create_hybrid_device_mesh(
            (1,) + tuple(ici_shape), (len(groups),) + (1,) * len(ici_shape),
            devices=devs, process_is_granule=False)
        if arr.shape != want:
            raise ValueError(f"hybrid mesh shape {arr.shape} != {want}")
        # inner axes must never cross a granule boundary
        for g in range(len(groups)):
            if len({_granule_key(d) for d in arr[g].ravel()}) != 1:
                raise ValueError("granule mixing in hybrid mesh")
    except Exception:
        arr = np.array([np.asarray(g).reshape(tuple(ici_shape)) for g in groups])
    return Mesh(arr, (dcn_axis,) + tuple(axis_names))
