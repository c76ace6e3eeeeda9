"""Slab R2C/C2C distributed transforms vs numpy oracles.

Reference test strategy (SURVEY.md §4): round-trip + vs-serial-numpy under
mpirun -np {1,2,4,8}; here the same matrix runs over 1/2/4/8-device CPU meshes.
Driver eval config 1 (BASELINE.md): slab R2C 3D 64³ float64 round-trip vs
numpy.fft.rfftn — covered by test_r2c_vs_numpy[8-double] at 64³ below.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab

TAU = 2 * np.pi


def make(N, P, precision="double", **kw):
    return slab.R2C(np.array([N, N, N]), np.array([TAU, TAU, TAU]), P, precision, **kw)


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("precision", ["single", "double"])
def test_r2c_vs_numpy(rng, P, precision):
    N = 16
    FFT = make(N, P, precision)
    u = rng.standard_normal((N, N, N)).astype(FFT.float)
    fu = FFT.fftn(FFT.shard_real(u))
    ref = np.fft.rfftn(u.astype(np.float64))
    # relative oracle (a silent precision regression must fail this)
    rtol = 1e-6 if precision == "single" else 1e-12
    assert fu.shape == FFT.global_complex_shape()
    assert np.abs(np.asarray(fu) - ref).max() / np.abs(ref).max() < rtol
    # round trip
    ub = FFT.ifftn(fu)
    assert np.abs(np.asarray(ub) - u).max() / np.abs(u).max() < rtol


def test_r2c_config1_64cubed(rng):
    """Driver eval config 1: slab R2C 64³ float64 vs numpy.fft.rfftn."""
    N = 64
    FFT = make(N, 8, "double")
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u))
    ref = np.fft.rfftn(u)
    denom = np.abs(ref).max()
    assert np.abs(fu - ref).max() / denom < 1e-12
    ub = np.asarray(FFT.ifftn(FFT.shard_complex(ref)))
    assert np.abs(ub - u).max() < 1e-12


@pytest.mark.parametrize("P", [1, 4])
def test_c2c_vs_numpy(rng, P):
    N = 16
    FFT = slab.C2C(np.array([N, N, N]), np.array([TAU] * 3), P, "double")
    u = rng.standard_normal((N, N, N)) + 1j * rng.standard_normal((N, N, N))
    fu = FFT.fftn(FFT.shard_real(u))
    assert np.allclose(np.asarray(fu), np.fft.fftn(u), atol=1e-9)
    ub = FFT.ifftn(fu)
    assert np.allclose(np.asarray(ub), u, atol=1e-11)


@pytest.mark.parametrize("P", [1, 4])
def test_dealias_23_rule(rng, P):
    N = 16
    FFT = make(N, P)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u, dealias="2/3-rule"))
    ref = np.fft.rfftn(u)
    # build the oracle mask
    k0 = np.fft.fftfreq(N, 1 / N)
    k2 = np.arange(N // 2 + 1)
    cut = 2 / 3 * (N // 2)
    mask = ((np.abs(k0)[:, None, None] < cut)
            & (np.abs(k0)[None, :, None] < cut)
            & (k2[None, None, :] < cut))
    assert np.allclose(fu, np.where(mask, ref, 0), atol=1e-9)
    # the user-facing filter matches too
    filt = np.asarray(FFT.get_dealias_filter())
    assert filt.shape == FFT.global_complex_shape()
    assert np.array_equal(filt.astype(bool), mask)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_padded_roundtrip_exact(rng, P):
    """3/2-rule: fftn(ifftn(fu, '3/2-rule'), '3/2-rule') == fu exactly
    (split-Nyquist pad/truncate adjointness)."""
    N = 16
    FFT = make(N, P)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u))  # a valid Hermitian spectrum
    up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
    assert up.shape == FFT.global_real_shape_padded()
    fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
    assert np.allclose(fu2, fu, atol=1e-10 * N ** 3)


def test_padded_physical_values(rng):
    """Padded inverse of a low-mode field == the analytic field sampled on the
    1.5× grid (physical consistency of the padsize**3 scaling)."""
    N = 16
    FFT = make(N, 2)
    x = np.arange(N) * TAU / N
    X = np.meshgrid(x, x, x, indexing="ij")
    u = np.cos(3 * X[0]) * np.sin(2 * X[1]) * np.sin(X[2])
    fu = FFT.fftn(u)
    up = np.asarray(FFT.ifftn(fu, dealias="3/2-rule"))
    M = 3 * N // 2
    xm = np.arange(M) * TAU / M
    Xm = np.meshgrid(xm, xm, xm, indexing="ij")
    um = np.cos(3 * Xm[0]) * np.sin(2 * Xm[1]) * np.sin(Xm[2])
    assert np.abs(up - um).max() < 1e-10


@pytest.mark.parametrize("P", [1, 4])
def test_wavenumber_mesh_and_local_shapes(P):
    N = 16
    FFT = make(N, P)
    K = np.asarray(FFT.get_local_wavenumbermesh())
    assert K.shape == (3,) + FFT.global_complex_shape()
    k0 = np.fft.fftfreq(N, 1 / N)
    assert np.array_equal(K[0][:, 0, 0], k0)
    assert np.array_equal(K[1][0, :, 0], k0)
    assert np.array_equal(K[2][0, 0, :], np.arange(N // 2 + 1))
    Ks = np.asarray(FFT.get_scaled_local_wavenumbermesh())
    assert np.allclose(Ks, K)  # L = 2π ⇒ scale 1
    # reference-parity local shape bookkeeping
    assert FFT.real_shape() == (N // P, N, N)
    assert FFT.complex_shape() == (N, N // P, N // 2 + 1)
    assert FFT.complex_shape_T() == (N // P, N, N // 2 + 1)
    assert FFT.complex_shape_I() == (P, N // P, N // P, N // 2 + 1)
    sl = FFT.complex_local_slice(rank=1 if P > 1 else 0)
    assert sl[1] == slice((N // P) if P > 1 else 0, (2 * N // P) if P > 1 else N // P)


def test_local_mesh():
    N = 16
    FFT = make(N, 4)
    X = np.asarray(FFT.get_local_mesh())
    assert X.shape == (3, N, N, N)
    x = np.arange(N) * TAU / N
    assert np.allclose(X[0][:, 0, 0], x)
    assert np.allclose(X[2][0, 0, :], x)


def test_work_arrays_and_datatypes():
    from mpifft4py_tpu import work_arrays, datatypes

    w = work_arrays()
    a = w[((4, 4), np.dtype(np.float64), 0)]
    assert a.shape == (4, 4)
    b = w[(a, 1)]
    assert b.shape == a.shape and b.dtype == a.dtype
    ft, ct, mt = datatypes("double")
    assert ct == np.complex128 and ft == np.float64
    ft, ct, mt = datatypes("single")
    assert ct == np.complex64 and ft == np.float32


def test_regrid_spectral_resampling(rng):
    """utils.spectral.regrid: exact trig interpolation up (coarse points are
    reproduced on a 2x-refined grid), down-then-up identity on band-limited
    data, and coarsening inverts refinement."""
    import jax.numpy as jnp
    from mpifft4py_tpu.utils.spectral import regrid

    u = rng.standard_normal((16, 16, 16))
    fu = np.fft.rfftn(u)
    # refine 16^3 -> 32^3: the trig interpolant passes through the samples
    fu_f = np.asarray(regrid(jnp.asarray(fu), (32, 32, 32)))
    uf = np.fft.irfftn(fu_f, s=(32, 32, 32), axes=(0, 1, 2))
    assert np.abs(uf[::2, ::2, ::2] - u).max() < 1e-12
    # coarsening inverts refinement exactly
    back = np.asarray(regrid(jnp.asarray(fu_f), (16, 16, 16)))
    assert np.allclose(back, fu, atol=1e-10)
    # anisotropic new grid + band-limited down: refine only z, then coarsen
    fz = np.asarray(regrid(jnp.asarray(fu), (16, 16, 48)))
    assert fz.shape == (16, 16, 25)
    assert np.allclose(np.asarray(regrid(jnp.asarray(fz), (16, 16, 16))), fu,
                       atol=1e-10)
    # numpy input stays numpy, identical values
    fn = regrid(np.asarray(fu), (32, 32, 32))
    assert isinstance(fn, np.ndarray)
    assert np.allclose(fn, fu_f, atol=1e-12)
    # alignment-padded width (pencil Nfp > Nf) with explicit N_old
    fpad = np.concatenate([np.asarray(fu),
                           np.zeros((16, 16, 3), fu.dtype)], axis=-1)
    fp = regrid(fpad, (32, 32, 32), N_old=(16, 16, 16))
    assert np.allclose(fp, fu_f, atol=1e-12)
