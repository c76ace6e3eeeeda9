"""3/2-rule forward of a *product* field vs the exact alias-sum oracle.

trunc_half_axis doubles the z-Nyquist coefficient, which equals
the true alias sum  ĉ_M[k0,k1,N/2] + conj(ĉ_M[−k0,−k1,N/2])  only when that
plane is self-conjugate — true for round trips, false for a general dealiased
product (u·v).  The padded forwards now Hermitian-symmetrize that plane
(utils.spectral.flip_conj_plane); these tests check the forward of a squared
field against a numpy oracle that folds the aliases exactly.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil, line

TAU = 2 * np.pi


def _oracle_3d(w_M, N, padsize):
    """Exact N-grid spectrum of the M-grid field w_M (trunc with alias folds)."""
    ref = np.fft.rfftn(w_M) / padsize ** 3
    h0, h1, hz = N // 2, N // 2, N // 2
    M = w_M.shape[0]

    def fold_full(c, axis, n):
        h = n // 2
        sl = [slice(None)] * c.ndim
        pos = c[tuple(sl[:axis] + [slice(0, h)] + sl[axis + 1:])]
        ny = (c[tuple(sl[:axis] + [slice(h, h + 1)] + sl[axis + 1:])]
              + c[tuple(sl[:axis] + [slice(c.shape[axis] - h,
                                           c.shape[axis] - h + 1)] + sl[axis + 1:])])
        neg = c[tuple(sl[:axis] + [slice(c.shape[axis] - h + 1, None)] + sl[axis + 1:])]
        return np.concatenate([pos, ny, neg], axis=axis)

    c = fold_full(fold_full(ref, 0, N), 1, N)
    # z half-axis: body is a direct copy; Nyquist is the true alias sum
    body = c[..., :hz]
    nyq = c[..., hz] + np.conj(np.roll(np.flip(c[..., hz], (0, 1)), (1, 1), (0, 1)))
    return np.concatenate([body, nyq[..., None]], axis=-1)


@pytest.mark.parametrize("make", [
    lambda N: slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double"),
    lambda N: pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double", P1=2),
    lambda N: pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double",
                         P1=2, alignment="Y"),
], ids=["slab", "pencilX", "pencilY"])
def test_padded_forward_product_alias_exact(rng, make):
    N = 16
    FFT = make(N)
    u = rng.standard_normal((N, N, N))
    # padded physical field of u, squared — a genuine dealiased product
    u_M = np.asarray(FFT.ifftn(FFT.fftn(u), dealias="3/2-rule"))
    w_M = u_M * u_M
    got = np.asarray(FFT.fftn(w_M, dealias="3/2-rule"))[..., :FFT.Nf]
    ref = _oracle_3d(w_M, N, FFT.padsize)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


def test_padded_forward_product_alias_exact_line(rng):
    N = 16
    FFT = line.R2C(np.array([N, N]), np.array([TAU] * 2), 4, "double")
    u = rng.standard_normal((N, N))
    u_M = np.asarray(FFT.ifft2(FFT.fft2(u), dealias="3/2-rule"))
    w_M = u_M * u_M
    got = np.asarray(FFT.fft2(w_M, dealias="3/2-rule"))[:, :FFT.Nf]
    ref2 = np.fft.rfft2(w_M) / FFT.padsize ** 2
    h = N // 2

    def fold0(c):
        pos = c[:h]
        ny = c[h:h + 1] + c[c.shape[0] - h:c.shape[0] - h + 1]
        neg = c[c.shape[0] - h + 1:]
        return np.concatenate([pos, ny, neg], axis=0)

    c = fold0(ref2)
    body = c[:, :h]
    nyq = c[:, h] + np.conj(np.roll(np.flip(c[:, h], 0), 1, 0))
    ref = np.concatenate([body, nyq[:, None]], axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.parametrize("make", [
    lambda N: slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double",
                       fp64_mode="doubleword"),
    lambda N: pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double",
                         P1=2, alignment="Y", fp64_mode="doubleword"),
], ids=["slab_dd", "pencilY_dd"])
def test_padded_forward_product_alias_dd(rng, make):
    """Doubleword paths apply the same symmetrization (leafwise flip/roll).
    CPU-jit dd accuracy caps at ~1e-6 (FMA contraction — see
    tests/test_doubledouble.py), but the unsymmetrized Nyquist residual is
    orders of magnitude larger, so 1e-4 still proves the fix."""
    N = 16
    FFT = make(N)
    assert FFT.policy.path == "doubleword"
    u = rng.standard_normal((N, N, N))
    u_M = FFT.gather_dd(FFT.ifftn(FFT.fftn(u), dealias="3/2-rule"))
    w_M = u_M * u_M
    got = FFT.gather_dd(FFT.fftn(w_M, dealias="3/2-rule"))[..., :FFT.Nf]
    ref = _oracle_3d(w_M, N, FFT.padsize)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_padded_roundtrip_still_exact(rng):
    """The symmetrization must be a no-op on round-trip (self-conjugate) data."""
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double")
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u))
    up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
    fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
    assert np.abs(fu2 - fu).max() / np.abs(fu).max() < 1e-12
