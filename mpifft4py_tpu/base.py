"""Shared machinery for the distributed transform classes (L3 tier).

Reference analog: the common shape/option bookkeeping spread across
``mpiFFT4py/{slab,pencil,line}.py`` (mount empty at build time; parity target
SURVEY.md §1, §3).  The JAX redesign:

* a "decomposition" is a ``jax.sharding.NamedSharding`` over a device Mesh, not
  index bookkeeping — local-shape helpers survive as thin derived quantities;
* transforms are pure jitted functions built with ``jax.shard_map``; local FFT
  stages run per-shard, global transposes are ``lax.all_to_all`` on named mesh
  axes (NCCL on GPUs);
* FFTW "plans" become jit-compiled executables cached per (direction, dealias)
  key in ``self._plans`` — first call compiles, later calls are cache hits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mpibase import DTypePolicy, resolve_precision, work_arrays
from .parallel.collectives import transpose, transpose_pipelined
from .parallel.mesh import mesh_size
from .utils.transfer import device_put as _device_put, to_numpy, zeros

shard_map = jax.shard_map


def local_wavenumber_full(n_global: int, n_local: int, block_index, dtype) -> jnp.ndarray:
    """fft-layout integer wavenumbers for a contiguous local block of a full axis.

    Global index j maps to wavenumber j (j < n/2) else j - n; ``block_index`` is
    the mesh position along the sharded axis (``lax.axis_index`` inside
    shard_map), so each device computes its own chunk — no host-side global
    meshes are ever materialised (replacement for the reference's
    ``get_local_wavenumbermesh`` numpy construction).
    """
    j = block_index * n_local + jnp.arange(n_local)
    return jnp.where(j < n_global // 2, j, j - n_global).astype(dtype)


class BaseFFT:
    """Common constructor/bookkeeping for slab/pencil/line transforms.

    Constructor signature mirrors the reference: ``R2C(N, L, comm, precision,
    communication=..., padsize=1.5, threads=..., planner_effort=...)``.
    ``comm`` is mesh-like (see ``parallel.mesh``); ``threads``/``planner_effort``
    are accepted for compatibility and ignored (XLA owns both concerns).
    ``communication`` accepts the reference values ("Alltoall"/"Alltoallw") —
    both map to ``lax.all_to_all`` (XLA fuses the pack/unpack the way
    Alltoallw's derived datatypes did) — plus "pipelined" to enable the
    chunked transpose/FFT-overlap path (``parallel.collectives``).
    """

    ndim: int = 3

    def __init__(self, N, L, comm=None, precision: str = "single", *,
                 communication: str = "Alltoall", padsize: float = 1.5,
                 threads=None, planner_effort=None, fp64_mode: str = "auto",
                 mesh: Optional[Mesh] = None, pipeline_chunks: int = 4):
        del threads, planner_effort  # XLA-owned concerns; accepted for API parity
        self._nchunks = int(pipeline_chunks)
        self.N = np.array(N, dtype=np.int64)
        self.L = np.array(L, dtype=np.float64)
        assert len(self.N) == self.ndim and len(self.L) == self.ndim
        if communication not in ("Alltoall", "Alltoallw", "alltoall",
                                 "pipelined"):
            raise ValueError(f"unknown communication={communication!r}")
        self.communication = communication
        self.padsize = float(padsize)
        self.policy: DTypePolicy = resolve_precision(precision, fp64_mode)
        self.float = self.policy.float
        self.complex = self.policy.complex
        self.mesh: Mesh = mesh if mesh is not None else self._make_mesh(comm)
        self.num_processes = self.P = mesh_size(self.mesh)
        self.rank = 0  # single-controller SPMD: the caller sees global arrays
        self.work_arrays = work_arrays()
        self._plans: Dict[Tuple, Callable] = {}
        self._validate()

    # -- subclass hooks --------------------------------------------------

    def _make_mesh(self, comm) -> Mesh:
        raise NotImplementedError

    def _validate(self) -> None:
        raise NotImplementedError

    def real_spec(self) -> P:
        raise NotImplementedError

    def complex_spec(self) -> P:
        raise NotImplementedError

    # -- shardings & field factories (additions to the reference API) -------

    def real_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.real_spec())

    def complex_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.complex_spec())

    def shard_real(self, u) -> jax.Array:
        """Place a host/global array as a properly sharded physical-space field."""
        return _device_put(u, self.float, self.real_sharding())

    def shard_complex(self, fu) -> jax.Array:
        return _device_put(fu, self.complex, self.complex_sharding())

    def gather(self, x) -> np.ndarray:
        """Fetch a (possibly sharded) field to host numpy."""
        return to_numpy(x)

    def zeros_real(self) -> jax.Array:
        return zeros(self.global_real_shape(), self.float, self.real_sharding())

    def zeros_complex(self) -> jax.Array:
        return zeros(self.global_complex_shape(), self.complex,
                     self.complex_sharding())

    # -- plan cache --------------------------------------------------------

    def _plan(self, key: Tuple, builder: Callable[[], Callable]) -> Callable:
        fn = self._plans.get(key)
        if fn is None:
            fn = self._plans[key] = jax.jit(builder())
        return fn

    def _smap(self, fn, in_specs, out_specs):
        return shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                         out_specs=out_specs)

    # -- transpose stage (comm + surrounding local FFT work) -----------------

    def _stage(self, x, axis_name: str, split_axis: int, concat_axis: int,
               work_fn: Optional[Callable] = None, *, pipeline_axis: int,
               pre_fn: Optional[Callable] = None,
               block_chunking: Optional[str] = None):
        """One transpose stage: ``work_fn(transpose(pre_fn(x)))``.

        Honors ``communication="pipelined"`` by chunking along
        ``pipeline_axis`` so the chunk-c collective overlaps chunk-(c−1)'s FFT
        (parallel.collectives.transpose_pipelined) — on EVERY path: plain,
        2/3-rule, 3/2-rule-padded, native and doubleword (pytree-aware).
        Degenerate (size-1) mesh axes skip the collective entirely.
        """
        if int(self.mesh.shape[axis_name]) == 1:
            if pre_fn is not None:
                x = pre_fn(x)
            return work_fn(x) if work_fn is not None else x
        if self.communication == "pipelined":
            return transpose_pipelined(x, axis_name, split_axis, concat_axis,
                                       work_fn, pipeline_axis,
                                       nchunks=self._nchunks, pre_fn=pre_fn,
                                       block_chunking=block_chunking,
                                       group_size=int(self.mesh.shape[axis_name]))
        if pre_fn is not None:
            x = pre_fn(x)
        x = transpose(x, axis_name, split_axis, concat_axis)
        return work_fn(x) if work_fn is not None else x

    # -- batched multi-component transforms (consumer convenience) -----------

    def forward_fields_fn(self, dealias=None) -> Callable:
        """Forward transform of a stack of fields: (C,) + work_shape ->
        (C,) + complex_shape.  The DNS consumer transforms 3-component
        velocity/vorticity stacks.  Per-component loop, pytree-stacked (works
        for native and doubleword fields)."""
        f = self.forward_fn(dealias)

        def batched(U):
            outs = [f(U[i]) for i in range(U.shape[0])]
            return jax.tree.map(lambda *vs: jnp.stack(vs), *outs)
        return batched

    def backward_fields_fn(self, dealias=None) -> Callable:
        f = self.backward_fn(dealias)

        def batched(FU):
            outs = [f(FU[i]) for i in range(FU.shape[0])]
            return jax.tree.map(lambda *vs: jnp.stack(vs), *outs)
        return batched

    # -- misc reference-parity helpers --------------------------------------

    def get_N(self):
        return self.N

    def _coerce(self, a, dtype, sharding) -> jax.Array:
        if isinstance(a, jax.Array) and a.dtype == dtype:
            return a
        return _device_put(a, dtype, sharding)
