"""Pencil (2D) decomposition of 3D FFTs.

Reference analog: ``mpiFFT4py/pencil.py`` ``R2C`` on a P1×P2 process grid
(reference mount empty at build time; parity target SURVEY.md §2.1 #4, §3.4).
Algorithm (the textbook pencil pipeline):

    forward:  local rfft(axis 2) → transpose over P2 → local fft(axis 1)
              → transpose over P1 → local fft(axis 0)
    inverse:  mirror image.

Mapping onto JAX:

* process grid        = 2D ``Mesh`` with axes ``("p1", "p2")`` — the two
  orthogonal sub-communicators the reference builds with ``Comm.Split`` are
  exactly the named mesh axes; each ``lax.all_to_all`` over one name is an
  Alltoall within one P1- or P2-sized group.
* layouts (global shapes; X-aligned spectral pencils, reference default):

      physical: real    (N0, N1, N2)    sharded P("p1", "p2", None)
      spectral: complex (N0, N1, Nfp)   sharded P(None, "p1", "p2")

* uneven Hermitian axis: pencil *must* shard the halved axis (Nf = N2//2+1,
  odd).  MPI does uneven blocks with Alltoallw derived datatypes; the static-
  shape equivalent is alignment padding to ``Nfp = ceil(Nf/P2)·P2`` with
  structural zero modes k >= Nf (transparent to spectral algebra, removed by
  every dealias mask, sliced off before the final irfft).
* ``alignment="X"`` (reference kwarg) selects which axis the spectral array
  is aligned with.  "X" (axis 0 local, transpose order z→y→x — the reference
  default): spectral P(None, "p1", "p2").  "Y" (axis 1 local, order z→x→y):
  spectral P("p2", None, "p1") with the Hermitian axis padded over P1.

Divisibility requirements (hard asserts, reference-parity): P1 | N0, P2 | N1,
P1 | N1; padded variants additionally need P1 | M0, P2 | M1.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from .base import BaseFFT, local_wavenumber_full
from .parallel.mesh import AXIS1, AXIS2, pencil_mesh, check_divisible
from .ops import fft_core as fc
from .utils.spectral import (
    pad_full_axis, trunc_full_axis, pad_half_axis, trunc_half_axis,
    dealias_cutoffs, flip_conj_plane,
)

__all__ = ["R2C", "C2C"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Pencil3D(BaseFFT):
    """Shared pencil machinery; subclasses fix the last-axis transform
    (R2C: halved Hermitian axis with Nfp alignment padding; C2C: full
    complex axis, divisibility-sharded)."""

    ndim = 3
    _is_r2c = True

    def __init__(self, N, L, comm=None, precision: str = "single", *,
                 P1=None, alignment: str = "X", **kw):
        if alignment not in ("X", "Y"):
            raise ValueError(f"alignment must be 'X' or 'Y', got {alignment!r}")
        self.alignment = alignment
        self._P1_req = P1
        super().__init__(N, L, comm, precision, **kw)

    def _make_mesh(self, comm):
        return pencil_mesh(comm, P1=self._P1_req)

    def _validate(self):
        if self.policy.path == "doubleword":
            from .ops import dd_fft  # noqa: F401
        self.P1 = int(self.mesh.shape[AXIS1])
        self.P2 = int(self.mesh.shape[AXIS2])
        check_divisible(self.N[0], self.P1, "pencil real axis 0 (P1)")
        check_divisible(self.N[1], self.P2, "pencil real axis 1 (P2)")
        check_divisible(self.N[1], self.P1, "pencil spectral axis 1 (P1)")
        for n in self.N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(self.N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)
        # last-axis spectral widths: R2C halves (Hermitian, Nf odd → Nfp
        # alignment padding); C2C keeps the full axis (divisibility-sharded,
        # no padding — fftshift layout makes end-padding meaningless).
        if self._is_r2c:
            self.Nf = int(self.N[2]) // 2 + 1
            self.Mf = int(self.M[2]) // 2 + 1
        else:
            self.Nf = int(self.N[2])
            self.Mf = int(self.M[2])
        # X-aligned shards the Hermitian axis over P2; Y-aligned (mirror
        # transpose order z→x→y) shards it over P1 and the leading axis over P2.
        if self.alignment == "Y":
            check_divisible(self.N[0], self.P2, "pencil Y spectral axis 0 (P2)")
            self.Nfp = _cdiv(self.Nf, self.P1) * self.P1
        else:
            self.Nfp = _cdiv(self.Nf, self.P2) * self.P2
        if not self._is_r2c and self.Nfp != self.Nf:
            ax, p = (("P1", self.P1) if self.alignment == "Y"
                     else ("P2", self.P2))
            raise ValueError(f"pencil C2C needs {ax} | N2 "
                             f"(got N2={self.Nf}, {ax}={p})")

    # -- shapes -----------------------------------------------------------------

    def real_shape(self):
        return (int(self.N[0]) // self.P1, int(self.N[1]) // self.P2, int(self.N[2]))

    def complex_shape(self):
        if self.alignment == "Y":
            return (int(self.N[0]) // self.P2, int(self.N[1]), self.Nfp // self.P1)
        return (int(self.N[0]), int(self.N[1]) // self.P1, self.Nfp // self.P2)

    def global_real_shape(self):
        return tuple(int(n) for n in self.N)

    def global_complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self.Nfp)

    def real_shape_padded(self):
        return (int(self.M[0]) // self.P1, int(self.M[1]) // self.P2, int(self.M[2]))

    def global_real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def work_shape(self, dealias=None):
        return self.real_shape_padded() if dealias == "3/2-rule" else self.real_shape()

    def real_local_slice(self, coords=(0, 0), padsize: float = 1.0):
        r1, r2 = coords
        n0 = int(round(padsize * self.N[0])) // self.P1
        n1 = int(round(padsize * self.N[1])) // self.P2
        return (slice(r1 * n0, (r1 + 1) * n0), slice(r2 * n1, (r2 + 1) * n1),
                slice(0, int(round(padsize * self.N[2]))))

    def complex_local_slice(self, coords=(0, 0)):
        r1, r2 = coords
        if self.alignment == "Y":
            n0 = int(self.N[0]) // self.P2
            nf = self.Nfp // self.P1
            return (slice(r2 * n0, (r2 + 1) * n0), slice(0, int(self.N[1])),
                    slice(r1 * nf, (r1 + 1) * nf))
        n1 = int(self.N[1]) // self.P1
        nf = self.Nfp // self.P2
        return (slice(0, int(self.N[0])), slice(r1 * n1, (r1 + 1) * n1),
                slice(r2 * nf, (r2 + 1) * nf))

    # -- shardings ----------------------------------------------------------------

    def real_spec(self):
        return P(AXIS1, AXIS2, None)

    def complex_spec(self):
        if self.alignment == "Y":
            return P(AXIS2, None, AXIS1)
        return P(None, AXIS1, AXIS2)

    # -- wavenumbers / masks ---------------------------------------------------------

    def _k2_chunk(self, nf, r, dtype):
        """Local chunk of last-axis wavenumbers (R2C: non-negative rfft
        indices; C2C override: signed fft-layout values)."""
        return (r * nf + jnp.arange(nf)).astype(dtype)

    def _k_local(self, dtype):
        N0, N1 = int(self.N[0]), int(self.N[1])
        multi = self.P > 1
        r1 = lax.axis_index(AXIS1) if multi else 0
        r2 = lax.axis_index(AXIS2) if multi else 0
        if self.alignment == "Y":
            n0 = N0 // self.P2
            nf = self.Nfp // self.P1
            k0 = local_wavenumber_full(N0, n0, r2, dtype)
            k1 = local_wavenumber_full(N1, N1, 0, dtype)
            return k0, k1, self._k2_chunk(nf, r1, dtype)
        n1 = N1 // self.P1
        nf = self.Nfp // self.P2
        k0 = local_wavenumber_full(N0, N0, 0, dtype)
        k1 = local_wavenumber_full(N1, n1, r1, dtype)
        return k0, k1, self._k2_chunk(nf, r2, dtype)

    def _mesh_build(self, builder, out_spec):
        if self.P == 1:
            return jax.jit(builder)()
        return jax.jit(self._smap(builder, in_specs=(), out_specs=out_spec))()

    def get_local_wavenumbermesh(self):
        def build():
            k0, k1, k2 = self._k_local(self.float)
            return jnp.stack(jnp.meshgrid(k0, k1, k2, indexing="ij"))
        return self._mesh_build(build, P(*((None,) + tuple(self.complex_spec()))))

    def get_scaled_local_wavenumbermesh(self):
        s = (2 * np.pi / self.L).astype(self.float)
        def build():
            k0, k1, k2 = self._k_local(self.float)
            return jnp.stack(jnp.meshgrid(k0 * s[0], k1 * s[1], k2 * s[2],
                                          indexing="ij"))
        return self._mesh_build(build, P(*((None,) + tuple(self.complex_spec()))))

    def get_dealias_filter(self):
        def build():
            return self._dealias_local()
        return self._mesh_build(build, self.complex_spec())

    def _dealias_local(self):
        c = dealias_cutoffs(self.N)
        k0, k1, k2 = self._k_local(jnp.float32)
        return ((jnp.abs(k0)[:, None, None] < c[0])
                & (jnp.abs(k1)[None, :, None] < c[1])
                & (jnp.abs(k2)[None, None, :] < c[2]))

    def get_local_mesh(self):
        N = [int(n) for n in self.N]
        d = (self.L / self.N).astype(self.float)
        n0, n1 = N[0] // self.P1, N[1] // self.P2
        multi = self.P > 1
        def build():
            r1 = lax.axis_index(AXIS1) if multi else 0
            r2 = lax.axis_index(AXIS2) if multi else 0
            x0 = (r1 * n0 + jnp.arange(n0, dtype=self.float)) * d[0]
            x1 = (r2 * n1 + jnp.arange(n1, dtype=self.float)) * d[1]
            x2 = jnp.arange(N[2], dtype=self.float) * d[2]
            return jnp.stack(jnp.meshgrid(x0, x1, x2, indexing="ij"))
        return self._mesh_build(build, P(None, AXIS1, AXIS2, None))

    # -- local pipelines -----------------------------------------------------------

    def _align_pad2(self, x):
        if x.shape[2] == self.Nfp:
            return x
        return jnp.pad(x, [(0, 0), (0, 0), (0, self.Nfp - x.shape[2])])

    def _fwd_local(self, u, dealias):
        padded = dealias == "3/2-rule"
        N0, N1 = int(self.N[0]), int(self.N[1])
        x = self._fft_last(u)                     # (n0, n1, Nf|Mf widths)
        if padded:
            x = self._trunc_last(x)
        x = self._align_pad2(x)                        # (n0, n1, Nfp)

        def fft_t(axis, n):
            # local FFT + (padded) truncation folded into the stage work_fn —
            # under "pipelined" the chunk-c transpose overlaps chunk-(c−1)'s
            # FFT (BASELINE config 5), on the plain AND 3/2-rule paths.
            if padded:
                return lambda y: trunc_full_axis(fc.fft(y, axis=axis), axis, n)
            return lambda y: fc.fft(y, axis=axis)

        if self.alignment == "Y":
            # mirror transpose order z→x→y: Hermitian axis over P1, axis 0
            # over P2 in spectral space
            x = self._stage(x, AXIS1, 2, 0, fft_t(0, N0), pipeline_axis=1)
            x = self._stage(x, AXIS2, 0, 1, fft_t(1, N1), pipeline_axis=2)
        else:
            x = self._stage(x, AXIS2, 2, 1, fft_t(1, N1), pipeline_axis=0)
            x = self._stage(x, AXIS1, 1, 0, fft_t(0, N0), pipeline_axis=2)
        if padded:
            x = self._fix_nyq(x)
            return x * self.complex.type(1.0 / self.padsize ** 3)
        if dealias == "2/3-rule":
            x = jnp.where(self._dealias_local(), x, 0)
        return x

    def _fix_nyq(self, x):
        """Padded-forward Hermitian fix (R2C: symmetrize the z-Nyquist
        plane; C2C override: nothing to fix — no Hermitian constraint)."""
        return self._sym_nyq(x)

    def _sym_nyq(self, x):
        """Hermitian-symmetrize the z-Nyquist plane of a padded forward
        (see slab._Slab3D._sym_nyq).  The Hermitian axis is SHARDED here, so
        only the rank whose chunk holds global k2 = Nf−1 applies the fix; the
        in-plane flip spans one local full axis and one sharded axis (gather
        that single plane over the sharded axis' group)."""
        if self.alignment == "Y":
            # layout (n0, N1, nf1): axis 0 over P2, Hermitian over P1
            chunk = self.Nfp // self.P1
            plane_axes, gather_axis_name, gather_axis = (0, 1), AXIS2, 0
            herm_axis_name, herm_P = AXIS1, self.P1
        else:
            # layout (N0, n1, nf2): axis 1 over P1, Hermitian over P2
            chunk = self.Nfp // self.P2
            plane_axes, gather_axis_name, gather_axis = (0, 1), AXIS1, 1
            herm_axis_name, herm_P = AXIS2, self.P2
        rank_ny, off = divmod(self.Nf - 1, chunk)
        q = x[..., off]
        if self.P == 1:
            f = flip_conj_plane(q, plane_axes)
        elif int(self.mesh.shape[gather_axis_name]) == 1:
            f = flip_conj_plane(q, plane_axes)
        else:
            full = lax.all_gather(q, gather_axis_name, axis=gather_axis,
                                  tiled=True)
            f = flip_conj_plane(full, plane_axes)
            n_loc = q.shape[gather_axis]
            r = lax.axis_index(gather_axis_name)
            f = lax.dynamic_slice_in_dim(f, r * n_loc, n_loc, gather_axis)
        sym = 0.5 * (q + f)
        if herm_P > 1:
            here = lax.axis_index(herm_axis_name) == rank_ny
            sym = jnp.where(here, sym, q)
        return x.at[..., off].set(sym)

    def _bwd_local(self, fu, dealias):
        padded = dealias == "3/2-rule"
        M0, M1 = int(self.M[0]), int(self.M[1])
        if dealias == "2/3-rule":
            fu = jnp.where(self._dealias_local(), fu, 0)

        def ifft_p(axis, m):
            # (padded) zero-fill + local inverse FFT as the stage pre_fn: under
            # "pipelined" chunk c's transpose overlaps chunk (c+1)'s FFT.
            if padded:
                return lambda y: fc.ifft(pad_full_axis(y, axis, m), axis=axis)
            return lambda y: fc.ifft(y, axis=axis)

        if self.alignment == "Y":
            x = self._stage(fu, AXIS2, 1, 0, pipeline_axis=2, pre_fn=ifft_p(1, M1))
            x = self._stage(x, AXIS1, 0, 2, pipeline_axis=1, pre_fn=ifft_p(0, M0))
        else:
            x = self._stage(fu, AXIS1, 0, 1, pipeline_axis=2, pre_fn=ifft_p(0, M0))
            x = self._stage(x, AXIS2, 1, 2, pipeline_axis=0, pre_fn=ifft_p(1, M1))
        x = x[..., :self.Nf]                      # drop alignment padding
        if padded:
            x = self._pad_last(x)
            u = self._ifft_last(x, padded=True)
            return u * self.float.type(self.padsize ** 3)
        return self._ifft_last(x, padded=False)

    # -- double-word (emulated fp64) local pipelines ----------------------------------
    # Same choreography over DD/DDComplex float32-pair pytrees (see slab.py for
    # the design notes).

    def _align_pad2_dd(self, x):
        if x.shape[2] == self.Nfp:
            return x
        pad = [(0, 0), (0, 0), (0, self.Nfp - x.shape[2])]
        return x._map(lambda v: jnp.pad(v, pad))

    def _fwd_local_dd(self, u, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        padded = dealias == "3/2-rule"
        N0, N1 = int(self.N[0]), int(self.N[1])
        x = self._fft_last_dd(u)
        if padded:
            x = self._trunc_last_dd(x)
        x = self._align_pad2_dd(x)

        def fft_t(axis, n):
            if padded:
                return lambda y: sdd.trunc_full_axis_dd(
                    df.fft_dd(y, axis=axis), axis, n)
            return lambda y: df.fft_dd(y, axis=axis)

        if self.alignment == "Y":
            x = self._stage(x, AXIS1, 2, 0, fft_t(0, N0), pipeline_axis=1)
            x = self._stage(x, AXIS2, 0, 1, fft_t(1, N1), pipeline_axis=2)
        else:
            x = self._stage(x, AXIS2, 2, 1, fft_t(1, N1), pipeline_axis=0)
            x = self._stage(x, AXIS1, 1, 0, fft_t(0, N0), pipeline_axis=2)
        if padded:
            x = self._fix_nyq_dd(x)
            return x * DD.from_f64(np.array(1.0 / self.padsize ** 3))
        if dealias == "2/3-rule":
            x = dd_where(self._dealias_local(), x)
        return x

    def _fix_nyq_dd(self, x):
        return self._sym_nyq_dd(x)

    def _sym_nyq_dd(self, x):
        """Doubleword variant of _sym_nyq (same rank/offset bookkeeping)."""
        from .utils import spectral_dd as sdd
        if self.alignment == "Y":
            chunk = self.Nfp // self.P1
            gather_axis_name, gather_axis = AXIS2, 0
            herm_axis_name, herm_P = AXIS1, self.P1
        else:
            chunk = self.Nfp // self.P2
            gather_axis_name, gather_axis = AXIS1, 1
            herm_axis_name, herm_P = AXIS2, self.P2
        rank_ny, off = divmod(self.Nf - 1, chunk)
        q = x[..., off]
        if self.P == 1 or int(self.mesh.shape[gather_axis_name]) == 1:
            f = sdd.flip_conj_plane_dd(q, (0, 1))
        else:
            full = jax.tree.map(
                lambda v: lax.all_gather(v, gather_axis_name,
                                         axis=gather_axis, tiled=True), q)
            f = sdd.flip_conj_plane_dd(full, (0, 1))
            n_loc = q.shape[gather_axis]
            r = lax.axis_index(gather_axis_name)
            f = jax.tree.map(
                lambda v: lax.dynamic_slice_in_dim(v, r * n_loc, n_loc,
                                                   gather_axis), f)
        sym = (q + f)._map(lambda v: v * jnp.float32(0.5))
        cond = (lax.axis_index(herm_axis_name) == rank_ny) if herm_P > 1 else None
        return sdd.sym_select_set_dd(x, off, sym, cond)

    def _bwd_local_dd(self, fu, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        padded = dealias == "3/2-rule"
        M0, M1 = int(self.M[0]), int(self.M[1])
        if dealias == "2/3-rule":
            fu = dd_where(self._dealias_local(), fu)

        def ifft_p(axis, m):
            if padded:
                return lambda y: df.ifft_dd(
                    sdd.pad_full_axis_dd(y, axis, m), axis=axis)
            return lambda y: df.ifft_dd(y, axis=axis)

        if self.alignment == "Y":
            x = self._stage(fu, AXIS2, 1, 0, pipeline_axis=2, pre_fn=ifft_p(1, M1))
            x = self._stage(x, AXIS1, 0, 2, pipeline_axis=1, pre_fn=ifft_p(0, M0))
        else:
            x = self._stage(fu, AXIS1, 0, 1, pipeline_axis=2, pre_fn=ifft_p(0, M0))
            x = self._stage(x, AXIS2, 1, 2, pipeline_axis=0, pre_fn=ifft_p(1, M1))
        x = x[..., :self.Nf]
        if padded:
            x = self._pad_last_dd(x)
            u = self._ifft_last_dd(x, padded=True)
            return u * DD.from_f64(np.array(self.padsize ** 3))
        return self._ifft_last_dd(x, padded=False)

    # -- public transforms ------------------------------------------------------------

    def _check_padded(self, dealias):
        if dealias == "3/2-rule":
            check_divisible(self.M[0], self.P1, "pencil padded axis 0 (P1)")
            check_divisible(self.M[1], self.P2, "pencil padded axis 1 (P2)")

    def forward_fn(self, dealias=None):
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._fwd_local_dd if dd else self._fwd_local
        if self.P == 1:
            return lambda u: local(u, dealias)
        return self._smap(lambda u: local(u, dealias),
                          in_specs=self.real_spec(), out_specs=self.complex_spec())

    def backward_fn(self, dealias=None):
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._bwd_local_dd if dd else self._bwd_local
        if self.P == 1:
            return lambda fu: local(fu, dealias)
        return self._smap(lambda fu: local(fu, dealias),
                          in_specs=self.complex_spec(), out_specs=self.real_spec())

    def shard_real_dd(self, u):
        from .ops.doubledouble import DD
        d = DD.from_f64(np.asarray(u, np.float64))
        sh = NamedSharding(self.mesh, self.real_spec())
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)

    def shard_complex_dd(self, fu):
        from .ops.doubledouble import DDComplex
        d = DDComplex.from_c128(np.asarray(fu, np.complex128))
        sh = self.complex_sharding()
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)

    def gather_dd(self, x):
        from .ops.doubledouble import DD, DDComplex
        if isinstance(x, DDComplex):
            return x.to_c128()
        if isinstance(x, DD):
            return x.to_f64()
        return self.gather(x)

    def fftn(self, u, fu=None, dealias=None):
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(u, (DD, DDComplex)):
                u = self.shard_real_dd(u)
        else:
            u = self._coerce(u, self._in_dtype,
                             NamedSharding(self.mesh, self.real_spec()))
        plan = self._plan(("fftn", dealias), lambda: self.forward_fn(dealias))
        return plan(u)

    def ifftn(self, fu, u=None, dealias=None):
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(fu, (DD, DDComplex)):
                fu = self.shard_complex_dd(fu)
        else:
            fu = self._coerce(fu, self.complex, self.complex_sharding())
        plan = self._plan(("ifftn", dealias), lambda: self.backward_fn(dealias))
        return plan(fu)


class R2C(_Pencil3D):
    """Real ↔ complex 3D pencil transform (reference: mpiFFT4py/pencil.py R2C,
    mount empty at build time — SURVEY.md §2.1 #4, §3.4)."""

    _is_r2c = True

    @property
    def _in_dtype(self):
        return self.float

    def _fft_last(self, u):
        return fc.rfft(u, axis=2)

    def _ifft_last(self, x, padded):
        n = int(self.M[2] if padded else self.N[2])
        return fc.irfft(x, n=n, axis=2).astype(self.float)

    def _trunc_last(self, x):
        return trunc_half_axis(x, 2, self.Nf)

    def _pad_last(self, x):
        return pad_half_axis(x, 2, self.Mf)

    # doubleword hooks
    def _fft_last_dd(self, u):
        from .ops import dd_fft as df
        return df.rfft_dd(u, axis=2)

    def _ifft_last_dd(self, x, padded):
        from .ops import dd_fft as df
        return df.irfft_dd(x, axis=2, n=int(self.M[2] if padded else self.N[2]))

    def _trunc_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.trunc_half_axis_dd(x, 2, self.Nf)

    def _pad_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.pad_half_axis_dd(x, 2, self.Mf)


class C2C(_Pencil3D):
    """Complex ↔ complex 3D pencil transform.

    Scope source: BASELINE.json:5 puts complex↔complex over BOTH
    decompositions in scope (reference mount empty; ``slab.C2C`` at
    slab.py is the distributed template).

    Both spaces are complex (N0, N1, N2); physical sharded
    P("p1", "p2", None), spectral (alignment "X") P(None, "p1", "p2") with
    the FULL last axis sharded by divisibility — no Nfp alignment padding,
    because the c2c fft layout stores negative frequencies in the upper
    half of the axis, so end-padding would land between +k and −k.
    Requires P2 | N2 ("X") or P1 | N2 ("Y").
    """

    _is_r2c = False

    @property
    def _in_dtype(self):
        return self.complex

    def _k2_chunk(self, nf, r, dtype):
        return local_wavenumber_full(int(self.N[2]), nf, r, dtype)

    def _fft_last(self, u):
        return fc.fft(u, axis=2)

    def _ifft_last(self, x, padded):
        return fc.ifft(x, axis=2)

    def _trunc_last(self, x):
        return trunc_full_axis(x, 2, int(self.N[2]))

    def _pad_last(self, x):
        return pad_full_axis(x, 2, int(self.M[2]))

    def _fix_nyq(self, x):
        return x  # full complex spectrum: no Hermitian constraint to repair

    def _fix_nyq_dd(self, x):
        return x

    def shard_real(self, u):
        """'Physical' space is complex for C2C."""
        from .utils.transfer import device_put as _dp
        return _dp(u, self.complex, NamedSharding(self.mesh, self.real_spec()))

    # doubleword hooks (complex physical space)
    def _fft_last_dd(self, u):
        from .ops import dd_fft as df
        return df.fft_dd(u, axis=2)

    def _ifft_last_dd(self, x, padded):
        from .ops import dd_fft as df
        return df.ifft_dd(x, axis=2)

    def _trunc_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.trunc_full_axis_dd(x, 2, int(self.N[2]))

    def _pad_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.pad_full_axis_dd(x, 2, int(self.M[2]))

    def shard_real_dd(self, u):
        from .ops.doubledouble import DDComplex
        d = DDComplex.from_c128(np.asarray(u, np.complex128))
        sh = NamedSharding(self.mesh, self.real_spec())
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)
