"""Slab (1D) decomposition of 3D FFTs.

Reference analog: ``mpiFFT4py/slab.py`` ``R2C``/``C2C`` (reference mount empty at
build time; parity target SURVEY.md §2.1 #3, §3.2–3.3 call stacks).  Algorithm
(the textbook slab pipeline, unchanged):

    forward:  local rfft2(axes 1,2) → global transpose → local fft(axis 0)
    inverse:  local ifft(axis 0)    → global transpose → local irfft2(axes 1,2)

Mapping onto JAX:

* decomposition      = ``NamedSharding`` over a 1D Mesh (axis ``"p"``):
  physical space sharded on axis 0, spectral space on axis 1; the halved
  (Hermitian) last axis is never sharded — same invariant as the reference.
* MPI ``Alltoall``   = ``lax.all_to_all(..., "p", tiled=True)`` inside
  ``shard_map`` — one collective per direction (NCCL on GPUs).  The reference's
  explicit reshape/rollaxis pack/unpack around the Alltoall disappears: XLA
  fuses layout changes into the collective (the role Alltoallw's derived
  datatypes played).
* FFTW plans         = jit executables cached per (direction, dealias) key.
* dealias            = ``"2/3-rule"`` (spectral mask, computed shard-locally
  from ``lax.axis_index`` — never materialised globally) or ``"3/2-rule"``
  (padded transforms at ``padsize``×N with exact split-Nyquist pad/truncate,
  see ``utils.spectral``).  Padded traffic is *truncated before* the transpose
  on the forward path, so messages are N-sized, not M-sized — an improvement
  over the reference, which ships padded-size messages.

Scaling conventions are numpy's ("backward"): ``ifftn(fftn(u)) == u``; the
3/2-rule variants additionally scale by ``padsize**3`` (inverse) and its
reciprocal (forward) so the padded physical field samples the same continuum
function and the round trip is exact on retained modes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from .base import BaseFFT, local_wavenumber_full
from .parallel.mesh import AXIS, slab_mesh, check_divisible
from .ops import fft_core as fc
from .utils.spectral import (
    pad_full_axis, trunc_full_axis, pad_half_axis, trunc_half_axis,
    dealias_cutoffs, flip_conj_plane,
)

__all__ = ["R2C", "C2C"]


class _Slab3D(BaseFFT):
    """Shared slab machinery; subclasses fix the last-axis layout (half vs full)."""

    ndim = 3

    def _make_mesh(self, comm):
        return slab_mesh(comm)

    def _validate(self):
        if self.policy.path == "doubleword":
            from .ops import dd_fft  # noqa: F401 — raises if unavailable
        check_divisible(self.N[0], self.P, "slab real axis 0")
        check_divisible(self.N[1], self.P, "slab spectral axis 1")
        for n in self.N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(self.N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)

    # last-axis spectral length; R2C overrides with Nf = N2//2 + 1
    @property
    def _lastf(self) -> int:
        return int(self.N[2])

    @property
    def _lastf_padded(self) -> int:
        return int(self.M[2])

    # -- shapes (reference-parity helpers; "local" = per-device shard) -------

    def real_shape(self):
        return (int(self.N[0]) // self.P, int(self.N[1]), int(self.N[2]))

    def complex_shape(self):
        return (int(self.N[0]), int(self.N[1]) // self.P, self._lastf)

    def complex_shape_T(self):
        """Transposed (pre-Alltoall) spectral shape — reference slab.py parity."""
        return (int(self.N[0]) // self.P, int(self.N[1]), self._lastf)

    def complex_shape_I(self):
        """Alltoall send-view shape (P, Np0, Np1, Nf) — reference slab.py parity."""
        return (self.P, int(self.N[0]) // self.P, int(self.N[1]) // self.P, self._lastf)

    def global_real_shape(self):
        return tuple(int(n) for n in self.N)

    def global_complex_shape(self):
        return (int(self.N[0]), int(self.N[1]), self._lastf)

    def real_shape_padded(self):
        return (int(self.M[0]) // self.P, int(self.M[1]), int(self.M[2]))

    def global_real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def work_shape(self, dealias=None):
        """Physical-space (input of fftn / output of ifftn) local shape."""
        return self.real_shape_padded() if dealias == "3/2-rule" else self.real_shape()

    def global_work_shape(self, dealias=None):
        return self.global_real_shape_padded() if dealias == "3/2-rule" \
            else self.global_real_shape()

    def real_local_slice(self, rank: int = 0, padsize: float = 1.0):
        Np0 = int(round(padsize * self.N[0])) // self.P
        N = [int(round(padsize * n)) for n in self.N]
        return (slice(rank * Np0, (rank + 1) * Np0), slice(0, N[1]), slice(0, N[2]))

    def complex_local_slice(self, rank: int = 0):
        Np1 = int(self.N[1]) // self.P
        return (slice(0, int(self.N[0])), slice(rank * Np1, (rank + 1) * Np1),
                slice(0, self._lastf))

    # -- shardings ------------------------------------------------------------

    def real_spec(self):
        return P(AXIS, None, None)

    def complex_spec(self):
        return P(None, AXIS, None)

    # -- wavenumber/coordinate meshes (built shard-locally, never on host) ----

    def _k_local(self, dtype):
        """Local spectral wavenumbers (k0 full, k1 chunk, k2) for layout
        (N0, Np1, lastf)."""
        N0, N1 = int(self.N[0]), int(self.N[1])
        Np1 = N1 // self.P
        r = lax.axis_index(AXIS) if self.P > 1 else 0
        k0 = local_wavenumber_full(N0, N0, 0, dtype)
        k1 = local_wavenumber_full(N1, Np1, r, dtype)
        if self._lastf == int(self.N[2]):  # c2c layout
            k2 = local_wavenumber_full(int(self.N[2]), int(self.N[2]), 0, dtype)
        else:
            k2 = jnp.arange(self._lastf, dtype=dtype)
        return k0, k1, k2

    def _mesh_build(self, builder, out_spec):
        if self.P == 1:
            return jax.jit(builder)()
        return jax.jit(self._smap(builder, in_specs=(), out_specs=out_spec))()

    def get_local_wavenumbermesh(self) -> jax.Array:
        """(3, N0, N1, Nf) integer wavenumbers, sharded like spectral space."""
        def build():
            k0, k1, k2 = self._k_local(self.float)
            K = jnp.meshgrid(k0, k1, k2, indexing="ij")
            return jnp.stack(K)
        return self._mesh_build(build, P(None, None, AXIS, None))

    def get_scaled_local_wavenumbermesh(self) -> jax.Array:
        """Physical wavenumbers k_i * 2π/L_i, sharded like spectral space."""
        scale = (2 * np.pi / self.L).astype(self.float)
        def build():
            k0, k1, k2 = self._k_local(self.float)
            K = jnp.meshgrid(k0 * scale[0], k1 * scale[1], k2 * scale[2], indexing="ij")
            return jnp.stack(K)
        return self._mesh_build(build, P(None, None, AXIS, None))

    def get_dealias_filter(self) -> jax.Array:
        """2/3-rule boolean mask, sharded like spectral space (reference parity)."""
        def build():
            return self._dealias_local()
        return self._mesh_build(build, P(None, AXIS, None))

    def _dealias_local(self) -> jnp.ndarray:
        c = dealias_cutoffs(self.N)
        k0, k1, k2 = self._k_local(jnp.float32)
        return ((jnp.abs(k0)[:, None, None] < c[0])
                & (jnp.abs(k1)[None, :, None] < c[1])
                & (jnp.abs(k2)[None, None, :] < c[2]))

    def get_local_mesh(self) -> jax.Array:
        """(3, N0, N1, N2) physical coordinates, sharded like physical space."""
        N = [int(n) for n in self.N]
        d = (self.L / self.N).astype(self.float)
        Np0 = N[0] // self.P
        Pn = self.P
        def build():
            r = lax.axis_index(AXIS) if Pn > 1 else 0
            x0 = (r * Np0 + jnp.arange(Np0, dtype=self.float)) * d[0]
            x1 = jnp.arange(N[1], dtype=self.float) * d[1]
            x2 = jnp.arange(N[2], dtype=self.float) * d[2]
            X = jnp.meshgrid(x0, x1, x2, indexing="ij")
            return jnp.stack(X)
        return self._mesh_build(build, P(None, AXIS, None, None))

    # -- local pipelines (run per-shard inside shard_map) ----------------------

    # subclass hooks: last-axis-aware local stages
    def _fft_yz(self, u):
        raise NotImplementedError

    def _ifft_yz(self, x, padded: bool):
        raise NotImplementedError

    def _trunc_last(self, x):
        raise NotImplementedError

    def _pad_last(self, x):
        raise NotImplementedError

    def _sym_nyq(self, x):
        """Hermitian-symmetrize the z-Nyquist plane of a padded R2C forward.

        trunc_half_axis doubles ĉ[k0,k1,N/2]; the exact alias sum is
        ĉ + conj(ĉ(−k0,−k1)), which differs for general dealiased products
        (tests/test_nyquist_alias.py).  Applied once all axes are spectral: axis 0 is local
        (full), axis 1 is sharded — gather just that plane (1/Nf of data).
        """
        q = x[..., -1]                                     # (N0, Np1)
        if self.P == 1:
            f = flip_conj_plane(q, (0, 1))
        else:
            full = lax.all_gather(q, AXIS, axis=1, tiled=True)   # (N0, N1)
            f = flip_conj_plane(full, (0, 1))
            np1 = q.shape[1]
            r = lax.axis_index(AXIS)
            f = lax.dynamic_slice_in_dim(f, r * np1, np1, 1)
        sym = 0.5 * (q + f)
        return jnp.concatenate([x[..., :-1], sym[..., None]], axis=-1)

    def _sym_nyq_dd(self, x):
        """Doubleword variant of _sym_nyq (leafwise flip/roll, dd average)."""
        from .utils import spectral_dd as sdd
        q = x[..., -1]
        if self.P == 1:
            f = sdd.flip_conj_plane_dd(q, (0, 1))
        else:
            full = jax.tree.map(
                lambda v: lax.all_gather(v, AXIS, axis=1, tiled=True), q)
            f = sdd.flip_conj_plane_dd(full, (0, 1))
            np1 = q.shape[1]
            r = lax.axis_index(AXIS)
            f = jax.tree.map(
                lambda v: lax.dynamic_slice_in_dim(v, r * np1, np1, 1), f)
        sym = (q + f)._map(lambda v: v * jnp.float32(0.5))
        return sdd.sym_select_set_dd(x, x.shape[-1] - 1, sym)

    def _fwd_local(self, u, dealias):
        # The single transpose overlaps the axis-0 FFT when
        # communication="pipelined", chunked on the independent Hermitian axis
        # (BASELINE config 5) — on the plain AND the 3/2-rule padded path.
        if dealias == "3/2-rule":
            x = self._fft_yz(u)                               # (Mp0, M1, Mf)
            x = trunc_full_axis(x, 1, int(self.N[1]))
            x = self._trunc_last(x)                           # (Mp0, N1, lastf)
            x = self._stage(x, AXIS, 1, 0,                    # (N0, Np1, lastf)
                            lambda y: trunc_full_axis(fc.fft(y, axis=0), 0,
                                                      int(self.N[0])),
                            pipeline_axis=2)
            if self._lastf != int(self.N[2]):  # R2C: fix the z-Nyquist plane
                x = self._sym_nyq(x)
            return x * self.complex.type(1.0 / self.padsize ** 3)
        x = self._fft_yz(u)                                   # (Np0, N1, lastf)
        x = self._stage(x, AXIS, 1, 0, lambda y: fc.fft(y, axis=0),
                        pipeline_axis=2)                      # (N0, Np1, lastf)
        if dealias == "2/3-rule":
            x = jnp.where(self._dealias_local(), x, 0)
        return x

    def _bwd_local(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = jnp.where(self._dealias_local(), fu, 0)
        if dealias == "3/2-rule":
            x = self._stage(fu, AXIS, 0, 1, pipeline_axis=2,  # (Mp0, N1, lastf)
                            pre_fn=lambda y: fc.ifft(
                                pad_full_axis(y, 0, int(self.M[0])), axis=0))
            x = pad_full_axis(x, 1, int(self.M[1]))
            x = self._pad_last(x)                             # (Mp0, M1, Mlastf)
            u = self._ifft_yz(x, padded=True)
            return u * self.float.type(self.padsize ** 3)
        x = self._stage(fu, AXIS, 0, 1, pipeline_axis=2,
                        pre_fn=lambda y: fc.ifft(y, axis=0))
        return self._ifft_yz(x, padded=False)

    # -- double-word (emulated fp64) local pipelines ---------------------------
    #
    # fp64_mode="doubleword" gives policy.path == "doubleword": fields are
    # DD / DDComplex pytrees of float32 pairs (ops.doubledouble) and the local
    # FFT stages run the dd Stockham kernels (ops.dd_fft).  The all-to-all
    # moves the four float32 leaves — same choreography, 2× the bytes of c64.
    # The error-free transforms assume no FMA contraction; XLA:CPU contracts
    # inside fusions and degrades dd accuracy to ~1e-7, so "double" resolves
    # to native float64 wherever x64 is on (policy "auto").

    def _fwd_local_dd(self, u, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        if dealias == "3/2-rule":
            x = self._fft_yz_dd(u)                              # (Mp0, M1, Mf')
            x = sdd.trunc_full_axis_dd(x, 1, int(self.N[1]))
            x = self._trunc_last_dd(x)
            x = self._stage(x, AXIS, 1, 0,
                            lambda y: sdd.trunc_full_axis_dd(
                                df.fft_dd(y, axis=0), 0, int(self.N[0])),
                            pipeline_axis=2)
            if self._lastf != int(self.N[2]):  # R2C: z-Nyquist alias sum
                x = self._sym_nyq_dd(x)
            s = DD.from_f64(np.array(1.0 / self.padsize ** 3))
            return x * s
        x = self._fft_yz_dd(u)
        x = self._stage(x, AXIS, 1, 0, lambda y: df.fft_dd(y, axis=0),
                        pipeline_axis=2)
        if dealias == "2/3-rule":
            x = dd_where(self._dealias_local(), x)
        return x

    def _bwd_local_dd(self, fu, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        if dealias == "2/3-rule":
            fu = dd_where(self._dealias_local(), fu)
        if dealias == "3/2-rule":
            x = self._stage(fu, AXIS, 0, 1, pipeline_axis=2,
                            pre_fn=lambda y: df.ifft_dd(
                                sdd.pad_full_axis_dd(y, 0, int(self.M[0])),
                                axis=0))
            x = sdd.pad_full_axis_dd(x, 1, int(self.M[1]))
            x = self._pad_last_dd(x)
            u = self._ifft_yz_dd(x, padded=True)
            s = DD.from_f64(np.array(self.padsize ** 3))
            return u * s
        x = self._stage(fu, AXIS, 0, 1, pipeline_axis=2,
                        pre_fn=lambda y: df.ifft_dd(y, axis=0))
        return self._ifft_yz_dd(x, padded=False)

    # -- public transforms ------------------------------------------------------

    def _check_padded(self, dealias):
        if dealias == "3/2-rule":
            check_divisible(self.M[0], self.P, "slab padded axis 0")

    def forward_fn(self, dealias=None):
        """The raw (unjitted) global->global forward, for composition into
        larger jitted programs (e.g. a DNS RK4 substep)."""
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._fwd_local_dd if dd else self._fwd_local
        if self.P == 1:
            return lambda u: local(u, dealias)
        in_spec = P(AXIS, None, None)
        return self._smap(lambda u: local(u, dealias),
                          in_specs=in_spec, out_specs=self.complex_spec())

    def backward_fn(self, dealias=None):
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._bwd_local_dd if dd else self._bwd_local
        if self.P == 1:
            return lambda fu: local(fu, dealias)
        out_spec = P(AXIS, None, None)
        return self._smap(lambda fu: local(fu, dealias),
                          in_specs=self.complex_spec(), out_specs=out_spec)

    # -- dd field construction ----------------------------------------------------

    def shard_real_dd(self, u):
        """Host float64 physical field → sharded DD (doubleword mode)."""
        from .ops.doubledouble import DD
        d = DD.from_f64(np.asarray(u, np.float64))
        sh = NamedSharding(self.mesh, P(AXIS, None, None))
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)

    def shard_complex_dd(self, fu):
        from .ops.doubledouble import DDComplex
        d = DDComplex.from_c128(np.asarray(fu, np.complex128))
        sh = self.complex_sharding()
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)

    def gather_dd(self, x):
        """DD / DDComplex → host numpy float64 / complex128."""
        from .ops.doubledouble import DD, DDComplex
        if isinstance(x, DDComplex):
            return x.to_c128()
        if isinstance(x, DD):
            return x.to_f64()
        return self.gather(x)

    def fftn(self, u, fu=None, dealias=None):
        """Forward 3D transform.  ``fu`` (reference out-param) accepted, ignored."""
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(u, (DD, DDComplex)):
                u = self.shard_real_dd(u)
        else:
            shard = NamedSharding(self.mesh, P(AXIS, None, None))
            u = self._coerce(u, self._in_dtype, shard)
        plan = self._plan(("fftn", dealias), lambda: self.forward_fn(dealias))
        return plan(u)

    def ifftn(self, fu, u=None, dealias=None):
        """Inverse 3D transform.  ``u`` (reference out-param) accepted, ignored."""
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(fu, (DD, DDComplex)):
                fu = self.shard_complex_dd(fu)
        else:
            fu = self._coerce(fu, self.complex, self.complex_sharding())
        plan = self._plan(("ifftn", dealias), lambda: self.backward_fn(dealias))
        return plan(fu)


class R2C(_Slab3D):
    """Real ↔ complex 3D slab transform (reference: mpiFFT4py/slab.py R2C).

    Physical space: real (N0, N1, N2), sharded on axis 0.
    Spectral space: complex (N0, N1, Nf=N2//2+1), sharded on axis 1; the halved
    Hermitian axis stays device-local (reference invariant, SURVEY.md §7).
    """

    @property
    def _lastf(self):
        return int(self.N[2]) // 2 + 1

    @property
    def _lastf_padded(self):
        return int(self.M[2]) // 2 + 1

    @property
    def _in_dtype(self):
        return self.float

    @property
    def Nf(self):
        return self._lastf

    def _fft_yz(self, u):
        return fc.rfft2(u, axes=(1, 2))

    def _ifft_yz(self, x, padded):
        s = tuple(int(v) for v in (self.M[1:] if padded else self.N[1:]))
        return fc.irfft2(x, s=s, axes=(1, 2)).astype(self.float)

    def _trunc_last(self, x):
        return trunc_half_axis(x, 2, self._lastf)

    def _pad_last(self, x):
        return pad_half_axis(x, 2, self._lastf_padded)

    # doubleword hooks
    def _fft_yz_dd(self, u):
        from .ops import dd_fft as df
        return df.fft_dd(df.rfft_dd(u, axis=2), axis=1)

    def _ifft_yz_dd(self, x, padded):
        from .ops import dd_fft as df
        n2 = int(self.M[2] if padded else self.N[2])
        return df.irfft_dd(df.ifft_dd(x, axis=1), axis=2, n=n2)

    def _trunc_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.trunc_half_axis_dd(x, 2, self._lastf)

    def _pad_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.pad_half_axis_dd(x, 2, self._lastf_padded)


class C2C(_Slab3D):
    """Complex ↔ complex 3D slab transform (reference: mpiFFT4py/slab.py C2C).

    Both spaces are complex (N0, N1, N2); physical sharded on axis 0, spectral
    on axis 1.  Same transpose choreography as R2C with a full last axis.
    """

    @property
    def _in_dtype(self):
        return self.complex

    def _fft_yz(self, u):
        return fc.fft2(u, axes=(1, 2))

    def _ifft_yz(self, x, padded):
        return fc.ifft2(x, axes=(1, 2))

    def _trunc_last(self, x):
        return trunc_full_axis(x, 2, int(self.N[2]))

    def _pad_last(self, x):
        return pad_full_axis(x, 2, int(self.M[2]))

    def real_shape(self):  # "real" space is complex for C2C; shapes unchanged
        return super().real_shape()

    def shard_real(self, u):
        from .utils.transfer import device_put as _dp
        return _dp(u, self.complex, NamedSharding(self.mesh, P(AXIS, None, None)))

    # doubleword hooks (complex "physical" space)
    def _fft_yz_dd(self, u):
        from .ops import dd_fft as df
        return df.fft_dd(df.fft_dd(u, axis=2), axis=1)

    def _ifft_yz_dd(self, x, padded):
        from .ops import dd_fft as df
        return df.ifft_dd(df.ifft_dd(x, axis=2), axis=1)

    def _trunc_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.trunc_full_axis_dd(x, 2, int(self.N[2]))

    def _pad_last_dd(self, x):
        from .utils import spectral_dd as sdd
        return sdd.pad_full_axis_dd(x, 2, int(self.M[2]))

    def shard_real_dd(self, u):
        from .ops.doubledouble import DDComplex
        d = DDComplex.from_c128(np.asarray(u, np.complex128))
        sh = NamedSharding(self.mesh, P(AXIS, None, None))
        return jax.tree.map(lambda v: jax.device_put(v, sh), d)
