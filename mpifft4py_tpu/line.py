"""Line (1D) decomposition of 2D FFTs.

Reference analog: ``mpiFFT4py/line.py`` ``R2C`` (reference mount empty at build
time; parity target SURVEY.md §2.1 #5).  Algorithm:

    forward:  local rfft(axis 1) → global transpose → local fft(axis 0)
    inverse:  local ifft(axis 0) → global transpose → local irfft(axis 1)

Layouts (global shapes; ``"p"`` = the 1D mesh axis):

    physical: real (N0, N1)          sharded P("p", None)
    spectral: complex (N0, Nfp)      sharded P(None, "p")

With only two axes the halved Hermitian axis *must* be sharded in spectral
space (unlike slab, which redistributes full axes only).  MPI handles the
uneven Nf = N1//2+1 with Alltoallw derived datatypes; the static-shape
equivalent is *alignment padding*: the spectral axis is padded to
``Nfp = ceil(Nf/P)·P`` with structural zeros (modes k >= Nf).  ``Nf`` and
``Nfp`` are both exposed; zeros are transparent to spectral algebra (masks and
wavenumber helpers give the padded modes k >= Nf, which every dealias cutoff
removes) and the inverse path slices them off before the final irfft.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from .base import BaseFFT, local_wavenumber_full
from .parallel.mesh import AXIS, slab_mesh, check_divisible
from .ops import fft_core as fc
from .utils.spectral import (
    pad_full_axis, trunc_full_axis, pad_half_axis, trunc_half_axis,
    dealias_cutoffs, flip_conj_plane,
)

__all__ = ["R2C"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class R2C(BaseFFT):
    """Real ↔ complex 2D line transform (reference: mpiFFT4py/line.py R2C)."""

    ndim = 2

    def _make_mesh(self, comm):
        return slab_mesh(comm)

    def _validate(self):
        if self.policy.path == "doubleword":
            from .ops import dd_fft  # noqa: F401
        check_divisible(self.N[0], self.P, "line real axis 0")
        for n in self.N:
            if n % 2:
                raise ValueError(f"grid sizes must be even, got {tuple(self.N)}")
        M = self.padsize * self.N
        if not np.allclose(M, np.round(M)):
            raise ValueError(f"padsize*N must be integral, got {M}")
        self.M = np.round(M).astype(np.int64)
        self.Nf = int(self.N[1]) // 2 + 1
        self.Nfp = _cdiv(self.Nf, self.P) * self.P      # alignment-padded
        self.Mf = int(self.M[1]) // 2 + 1
        self.Mfp = _cdiv(self.Mf, self.P) * self.P

    # -- shapes ---------------------------------------------------------------

    def real_shape(self):
        return (int(self.N[0]) // self.P, int(self.N[1]))

    def complex_shape(self):
        return (int(self.N[0]), self.Nfp // self.P)

    def global_real_shape(self):
        return tuple(int(n) for n in self.N)

    def global_complex_shape(self):
        return (int(self.N[0]), self.Nfp)

    def real_shape_padded(self):
        return (int(self.M[0]) // self.P, int(self.M[1]))

    def global_real_shape_padded(self):
        return tuple(int(m) for m in self.M)

    def work_shape(self, dealias=None):
        return self.real_shape_padded() if dealias == "3/2-rule" else self.real_shape()

    def real_local_slice(self, rank: int = 0, padsize: float = 1.0):
        Np0 = int(round(padsize * self.N[0])) // self.P
        return (slice(rank * Np0, (rank + 1) * Np0),
                slice(0, int(round(padsize * self.N[1]))))

    def complex_local_slice(self, rank: int = 0):
        c = self.Nfp // self.P
        return (slice(0, int(self.N[0])), slice(rank * c, (rank + 1) * c))

    # -- shardings --------------------------------------------------------------

    def real_spec(self):
        return P(AXIS, None)

    def complex_spec(self):
        return P(None, AXIS)

    # -- meshes / masks -----------------------------------------------------------

    def _k_local(self, dtype):
        N0 = int(self.N[0])
        cp = self.Nfp // self.P
        r = lax.axis_index(AXIS) if self.P > 1 else 0
        k0 = local_wavenumber_full(N0, N0, 0, dtype)
        k1 = (r * cp + jnp.arange(cp)).astype(dtype)   # rfft layout: 0..Nfp-1
        return k0, k1

    def _mesh_build(self, builder, out_spec):
        if self.P == 1:
            return jax.jit(builder)()
        return jax.jit(self._smap(builder, in_specs=(), out_specs=out_spec))()

    def get_local_wavenumbermesh(self):
        def build():
            k0, k1 = self._k_local(self.float)
            return jnp.stack(jnp.meshgrid(k0, k1, indexing="ij"))
        return self._mesh_build(build, P(None, None, AXIS))

    def get_scaled_local_wavenumbermesh(self):
        s = (2 * np.pi / self.L).astype(self.float)
        def build():
            k0, k1 = self._k_local(self.float)
            return jnp.stack(jnp.meshgrid(k0 * s[0], k1 * s[1], indexing="ij"))
        return self._mesh_build(build, P(None, None, AXIS))

    def get_dealias_filter(self):
        def build():
            return self._dealias_local()
        return self._mesh_build(build, P(None, AXIS))

    def _dealias_local(self):
        c = dealias_cutoffs(self.N)
        k0, k1 = self._k_local(jnp.float32)
        return (jnp.abs(k0)[:, None] < c[0]) & (jnp.abs(k1)[None, :] < c[1])

    def get_local_mesh(self):
        N = [int(n) for n in self.N]
        d = (self.L / self.N).astype(self.float)
        Np0 = N[0] // self.P
        Pn = self.P
        def build():
            r = lax.axis_index(AXIS) if Pn > 1 else 0
            x0 = (r * Np0 + jnp.arange(Np0, dtype=self.float)) * d[0]
            x1 = jnp.arange(N[1], dtype=self.float) * d[1]
            return jnp.stack(jnp.meshgrid(x0, x1, indexing="ij"))
        return self._mesh_build(build, P(None, AXIS, None))

    # -- local pipelines ------------------------------------------------------------

    def _align_pad(self, x, nf_valid: int, nfp: int):
        """Zero-fill the rfft axis from nf_valid to the alignment-padded nfp."""
        if x.shape[1] == nfp:
            return x
        pad = [(0, 0), (0, nfp - x.shape[1])]
        return jnp.pad(x, pad)

    def _fwd_local(self, u, dealias):
        # single transpose; "pipelined" chunks the per-device blocks of the
        # split axis (no free third axis in 2D — see collectives block_chunking)
        if dealias == "3/2-rule":
            x = fc.rfft(u, axis=1)                      # (Mp0, Mf)
            x = trunc_half_axis(x, 1, self.Nf)               # (Mp0, Nf)
            x = self._align_pad(x, self.Nf, self.Nfp)        # (Mp0, Nfp)
            x = self._stage(x, AXIS, 1, 0,                   # (N0, Nfp/P)
                            lambda y: trunc_full_axis(fc.fft(y, axis=0), 0,
                                                      int(self.N[0])),
                            pipeline_axis=1, block_chunking="split")
            x = self._sym_nyq(x)
            return x * self.complex.type(1.0 / self.padsize ** 2)
        x = fc.rfft(u, axis=1)                          # (Np0, Nf)
        x = self._align_pad(x, self.Nf, self.Nfp)
        x = self._stage(x, AXIS, 1, 0, lambda y: fc.fft(y, axis=0),
                        pipeline_axis=1, block_chunking="split")
        if dealias == "2/3-rule":
            x = jnp.where(self._dealias_local(), x, 0)
        return x

    def _sym_nyq(self, x):
        """Hermitian-symmetrize the y-Nyquist column of a padded forward:
        trunc_half_axis doubles it, the exact alias sum is q + conj(q(−k0))
        (see utils.spectral.trunc_half_axis).  The column lives on one rank
        of the sharded Hermitian axis; the flip is over the local full axis 0."""
        chunk = self.Nfp // self.P
        rank_ny, off = divmod(self.Nf - 1, chunk)
        q = x[:, off]                                    # (N0,)
        sym = 0.5 * (q + flip_conj_plane(q, (0,)))
        if self.P > 1:
            sym = jnp.where(lax.axis_index(AXIS) == rank_ny, sym, q)
        return x.at[:, off].set(sym)

    def _bwd_local(self, fu, dealias):
        if dealias == "2/3-rule":
            fu = jnp.where(self._dealias_local(), fu, 0)
        if dealias == "3/2-rule":
            x = self._stage(fu, AXIS, 0, 1, pipeline_axis=1,  # (Mp0, Nfp)
                            block_chunking="concat",
                            pre_fn=lambda y: fc.ifft(
                                pad_full_axis(y, 0, int(self.M[0])), axis=0))
            x = x[:, :self.Nf]                               # drop alignment pad
            x = pad_half_axis(x, 1, self.Mf)                 # (Mp0, Mf)
            u = fc.irfft(x, n=int(self.M[1]), axis=1)
            return (u * self.float.type(self.padsize ** 2)).astype(self.float)
        x = self._stage(fu, AXIS, 0, 1, pipeline_axis=1,
                        block_chunking="concat",
                        pre_fn=lambda y: fc.ifft(y, axis=0))
        x = x[:, :self.Nf]
        return fc.irfft(x, n=int(self.N[1]), axis=1).astype(self.float)

    # -- double-word (emulated fp64) local pipelines ------------------------------------

    def _fwd_local_dd(self, u, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        padded = dealias == "3/2-rule"
        x = df.rfft_dd(u, axis=1)
        if padded:
            x = sdd.trunc_half_axis_dd(x, 1, self.Nf)
        if x.shape[1] != self.Nfp:
            x = x._map(lambda v: jnp.pad(v, [(0, 0), (0, self.Nfp - v.shape[1])]))
        if padded:
            work = lambda y: sdd.trunc_full_axis_dd(
                df.fft_dd(y, axis=0), 0, int(self.N[0]))
        else:
            work = lambda y: df.fft_dd(y, axis=0)
        x = self._stage(x, AXIS, 1, 0, work, pipeline_axis=1,
                        block_chunking="split")
        if padded:
            x = self._sym_nyq_dd(x)
            return x * DD.from_f64(np.array(1.0 / self.padsize ** 2))
        if dealias == "2/3-rule":
            x = dd_where(self._dealias_local(), x)
        return x

    def _sym_nyq_dd(self, x):
        """Doubleword variant of _sym_nyq (1D flip on the local full axis)."""
        from .utils import spectral_dd as sdd
        chunk = self.Nfp // self.P
        rank_ny, off = divmod(self.Nf - 1, chunk)
        q = x[:, off]
        f = sdd.flip_conj_plane_dd(q, (0,))
        sym = (q + f)._map(lambda v: v * jnp.float32(0.5))
        cond = (lax.axis_index(AXIS) == rank_ny) if self.P > 1 else None
        return sdd.sym_select_set_dd(x, off, sym, cond)

    def _bwd_local_dd(self, fu, dealias):
        from .ops import dd_fft as df
        from .ops.doubledouble import DD, dd_where
        from .utils import spectral_dd as sdd

        padded = dealias == "3/2-rule"
        if dealias == "2/3-rule":
            fu = dd_where(self._dealias_local(), fu)
        if padded:
            pre = lambda y: df.ifft_dd(
                sdd.pad_full_axis_dd(y, 0, int(self.M[0])), axis=0)
        else:
            pre = lambda y: df.ifft_dd(y, axis=0)
        x = self._stage(fu, AXIS, 0, 1, pipeline_axis=1,
                        block_chunking="concat", pre_fn=pre)
        x = x[:, :self.Nf]
        if padded:
            x = sdd.pad_half_axis_dd(x, 1, self.Mf)
            u = df.irfft_dd(x, axis=1, n=int(self.M[1]))
            return u * DD.from_f64(np.array(self.padsize ** 2))
        return df.irfft_dd(x, axis=1, n=int(self.N[1]))

    def shard_real_dd(self, u):
        from .ops.doubledouble import DD
        from jax.sharding import NamedSharding
        d = DD.from_f64(np.asarray(u, np.float64))
        sh = NamedSharding(self.mesh, P(AXIS, None))
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

    # -- public transforms -------------------------------------------------------------

    def _check_padded(self, dealias):
        if dealias == "3/2-rule":
            check_divisible(self.M[0], self.P, "line padded axis 0")

    def forward_fn(self, dealias=None):
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._fwd_local_dd if dd else self._fwd_local
        if self.P == 1:
            return lambda u: local(u, dealias)
        return self._smap(lambda u: local(u, dealias),
                          in_specs=P(AXIS, None), out_specs=self.complex_spec())

    def backward_fn(self, dealias=None):
        self._check_padded(dealias)
        dd = self.policy.path == "doubleword"
        local = self._bwd_local_dd if dd else self._bwd_local
        if self.P == 1:
            return lambda fu: local(fu, dealias)
        return self._smap(lambda fu: local(fu, dealias),
                          in_specs=self.complex_spec(), out_specs=P(AXIS, None))

    def fft2(self, u, fu=None, dealias=None):
        """Forward 2D transform (reference line.R2C.fft2)."""
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(u, (DD, DDComplex)):
                u = self.shard_real_dd(u)
        else:
            from jax.sharding import NamedSharding
            u = self._coerce(u, self.float, NamedSharding(self.mesh, P(AXIS, None)))
        plan = self._plan(("fft2", dealias), lambda: self.forward_fn(dealias))
        return plan(u)

    def ifft2(self, fu, u=None, dealias=None):
        """Inverse 2D transform (reference line.R2C.ifft2)."""
        if self.policy.path == "doubleword":
            from .ops.doubledouble import DD, DDComplex
            if not isinstance(fu, (DD, DDComplex)):
                fu = self.shard_complex_dd(fu)
        else:
            fu = self._coerce(fu, self.complex, self.complex_sharding())
        plan = self._plan(("ifft2", dealias), lambda: self.backward_fn(dealias))
        return plan(fu)
