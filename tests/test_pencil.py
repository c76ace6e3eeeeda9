"""Pencil R2C (3D, 2D mesh decomposition) vs numpy oracles — driver eval config 4."""

import numpy as np
import pytest

from mpifft4py_tpu import pencil
from mpifft4py_tpu.parallel.mesh import pencil_mesh

TAU = 2 * np.pi


def make(N, comm=8, P1=None, precision="double", **kw):
    return pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), comm, precision,
                      P1=P1, **kw)


@pytest.mark.parametrize("P1", [1, 2, 4, 8])
@pytest.mark.parametrize("precision", ["single", "double"])
def test_pencil_vs_numpy(rng, P1, precision):
    N = 16
    FFT = make(N, 8, P1=P1, precision=precision)
    assert FFT.P1 * FFT.P2 == 8
    u = rng.standard_normal((N, N, N)).astype(FFT.float)
    fu = np.asarray(FFT.fftn(FFT.shard_real(u)))
    ref = np.fft.rfftn(u.astype(np.float64))
    # relative oracle check (a silent DEFAULT-precision matmul would fail this)
    rtol = 1e-6 if precision == "single" else 1e-12
    assert fu.shape == FFT.global_complex_shape()
    assert np.abs(fu[..., :FFT.Nf] - ref).max() / np.abs(ref).max() < rtol
    assert np.all(fu[..., FFT.Nf:] == 0)  # alignment-pad modes are structural zeros
    ub = np.asarray(FFT.ifftn(fu))
    assert np.abs(ub - u).max() / np.abs(u).max() < rtol


@pytest.mark.parametrize("alignment", ["X", "Y"])
@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("communication", ["Alltoall", "pipelined"])
def test_pencil_matrix(rng, alignment, precision, communication):
    """The full option matrix — every cell must work, no silent fallbacks:
    alignment x precision x communication, plain, 2/3-rule, and 3/2-rule."""
    N = 16
    FFT = make(N, 8, P1=2, precision=precision, alignment=alignment,
               communication=communication, pipeline_chunks=3)
    rtol = 1e-6 if precision == "single" else 1e-12
    u = rng.standard_normal((N, N, N)).astype(FFT.float)
    ref = np.fft.rfftn(u.astype(np.float64))
    fu = np.asarray(FFT.fftn(FFT.shard_real(u)))
    assert np.abs(fu[..., :FFT.Nf] - ref).max() / np.abs(ref).max() < rtol
    ub = np.asarray(FFT.ifftn(fu))
    assert np.abs(ub - u).max() / np.abs(u).max() < rtol
    # 3/2-rule padded round trip (the dealiased DNS path, BASELINE config 5)
    up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
    assert up.shape == FFT.global_real_shape_padded()
    fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
    assert np.abs(fu2 - fu).max() / np.abs(fu).max() < rtol
    # 2/3-rule mask
    fu23 = np.asarray(FFT.fftn(FFT.shard_real(u), dealias="2/3-rule"))
    filt = np.asarray(FFT.get_dealias_filter()).astype(bool)
    refm = np.where(filt[..., :FFT.Nf], ref, 0)
    assert np.abs(fu23[..., :FFT.Nf] - refm).max() / np.abs(ref).max() < rtol


def test_pencil_256_smoke_2x4(rng):
    """Driver eval config 4 (scaled down in dims but the real 2D-mesh path):
    pencil R2C on a P1×P2 = 2×4 process mesh."""
    N = 64
    FFT = make(N, 8, P1=2)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u))
    ref = np.fft.rfftn(u)
    assert np.abs(fu[..., :FFT.Nf] - ref).max() / np.abs(ref).max() < 1e-12
    ub = np.asarray(FFT.ifftn(FFT.shard_complex(fu)))
    assert np.abs(ub - u).max() < 1e-12


@pytest.mark.parametrize("P1", [2, 4])
def test_pencil_padded_roundtrip(rng, P1):
    N = 16
    FFT = make(N, 8, P1=P1)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u))
    up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
    assert up.shape == FFT.global_real_shape_padded()
    fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
    assert np.allclose(fu2, fu, atol=1e-10 * N ** 3)


def test_pencil_padded_physical(rng):
    N = 16
    FFT = make(N, 8, P1=2)
    x = np.arange(N) * TAU / N
    X = np.meshgrid(x, x, x, indexing="ij")
    u = np.cos(3 * X[0]) * np.sin(2 * X[1]) * np.sin(X[2])
    up = np.asarray(FFT.ifftn(FFT.fftn(u), dealias="3/2-rule"))
    M = 3 * N // 2
    xm = np.arange(M) * TAU / M
    Xm = np.meshgrid(xm, xm, xm, indexing="ij")
    um = np.cos(3 * Xm[0]) * np.sin(2 * Xm[1]) * np.sin(Xm[2])
    assert np.abs(up - um).max() < 1e-10


def test_pencil_dealias_matches_oracle(rng):
    N = 16
    FFT = make(N, 8, P1=4)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(FFT.fftn(u, dealias="2/3-rule"))
    ref = np.fft.rfftn(u)
    cut = 2 / 3 * (N // 2)
    k = np.fft.fftfreq(N, 1 / N)
    k2 = np.arange(FFT.Nfp)
    mask = ((np.abs(k)[:, None, None] < cut) & (np.abs(k)[None, :, None] < cut)
            & (k2[None, None, :] < cut))
    refm = np.where(mask[..., :FFT.Nf], ref, 0)
    assert np.allclose(fu[..., :FFT.Nf], refm, atol=1e-9)
    filt = np.asarray(FFT.get_dealias_filter())
    assert np.array_equal(filt.astype(bool), mask)


def test_pencil_wavenumbers_and_shapes():
    N = 16
    FFT = make(N, 8, P1=2)
    K = np.asarray(FFT.get_local_wavenumbermesh())
    k = np.fft.fftfreq(N, 1 / N)
    assert np.array_equal(K[0][:, 0, 0], k)
    assert np.array_equal(K[1][0, :, 0], k)
    assert np.array_equal(K[2][0, 0, :], np.arange(FFT.Nfp))
    assert FFT.real_shape() == (N // 2, N // 4, N)
    assert FFT.complex_shape() == (N, N // 2, FFT.Nfp // 4)
    X = np.asarray(FFT.get_local_mesh())
    assert np.allclose(X[0][:, 0, 0], np.arange(N) * TAU / N)


def test_pencil_mesh_factorization():
    m = pencil_mesh(8)
    assert m.shape["p1"] * m.shape["p2"] == 8
    assert m.shape["p1"] == 2  # most square with P1 <= P2


@pytest.mark.parametrize("P1", [2, 4])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
def test_pencil_alignment_y(rng, P1, dealias):
    """Y-aligned pencils (z→x→y transpose order): spectral axis 1 local."""
    N = 16
    FFT = make(N, 8, P1=P1, alignment="Y")
    assert FFT.complex_shape()[1] == N  # axis 1 local
    u = rng.standard_normal((N, N, N))
    if dealias == "3/2-rule":
        fu = np.asarray(FFT.fftn(u))
        up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
        fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
        assert np.allclose(fu2, fu, atol=1e-10 * N ** 3)
        return
    fu = np.asarray(FFT.fftn(u, dealias=dealias))
    ref = np.fft.rfftn(u)
    if dealias == "2/3-rule":
        filt = np.asarray(FFT.get_dealias_filter()).astype(bool)
        ref = np.where(filt[..., :FFT.Nf], ref, 0)
    assert np.allclose(fu[..., :FFT.Nf], ref, atol=1e-9)
    ub = np.asarray(FFT.ifftn(FFT.shard_complex(fu)))
    if dealias is None:
        assert np.allclose(ub, u, atol=1e-12)


def test_pencil_y_wavenumbers(rng):
    N = 16
    FFT = make(N, 8, P1=2, alignment="Y")
    K = np.asarray(FFT.get_local_wavenumbermesh())
    k = np.fft.fftfreq(N, 1 / N)
    assert np.array_equal(K[0][:, 0, 0], k)
    assert np.array_equal(K[1][0, :, 0], k)
    assert np.array_equal(K[2][0, 0, :], np.arange(FFT.Nfp))


# -- pencil.C2C -------------------------------------------------------------------


def make_c2c(N, comm=8, P1=None, precision="double", **kw):
    return pencil.C2C(np.array([N] * 3), np.array([TAU] * 3), comm, precision,
                      P1=P1, **kw)


@pytest.mark.parametrize("P1", [1, 2, 4, 8])
@pytest.mark.parametrize("precision", ["single", "double"])
def test_pencil_c2c_vs_numpy(rng, P1, precision):
    N = 16
    FFT = make_c2c(N, 8, P1=P1, precision=precision)
    rtol = 1e-6 if precision == "single" else 1e-12
    u = (rng.standard_normal((N, N, N))
         + 1j * rng.standard_normal((N, N, N))).astype(FFT.complex)
    fu = np.asarray(FFT.fftn(FFT.shard_real(u)))
    ref = np.fft.fftn(u.astype(np.complex128))
    assert fu.shape == FFT.global_complex_shape() == (N, N, N)
    assert np.abs(fu - ref).max() / np.abs(ref).max() < rtol
    ub = np.asarray(FFT.ifftn(fu))
    assert np.abs(ub - u).max() / np.abs(u).max() < rtol


@pytest.mark.parametrize("alignment", ["X", "Y"])
@pytest.mark.parametrize("communication", ["Alltoall", "pipelined"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
def test_pencil_c2c_matrix(rng, alignment, communication, dealias):
    """alignment x communication x dealias — full C2C option matrix."""
    N = 16
    FFT = make_c2c(N, 8, P1=2, alignment=alignment,
                   communication=communication, pipeline_chunks=3)
    u = (rng.standard_normal((N, N, N))
         + 1j * rng.standard_normal((N, N, N))).astype(np.complex128)
    ref = np.fft.fftn(u)
    if dealias == "3/2-rule":
        # padded round trip: exact on all N-grid modes
        fu = np.asarray(FFT.fftn(FFT.shard_real(u)))
        up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
        assert up.shape == FFT.global_real_shape_padded()
        fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
        assert np.abs(fu2 - fu).max() / np.abs(fu).max() < 1e-12
        return
    fu = np.asarray(FFT.fftn(FFT.shard_real(u), dealias=dealias))
    if dealias == "2/3-rule":
        filt = np.asarray(FFT.get_dealias_filter()).astype(bool)
        ref = np.where(filt, ref, 0)
    assert np.abs(fu - ref).max() / np.abs(ref).max() < 1e-12
    ub = np.asarray(FFT.ifftn(FFT.shard_complex(fu)))
    uref = np.fft.ifftn(ref)
    assert np.abs(ub - uref).max() / np.abs(uref).max() < 1e-12


def test_pencil_c2c_matches_slab_c2c(rng):
    """Same transform, different decomposition: pencil.C2C == slab.C2C."""
    from mpifft4py_tpu import slab

    N = 16
    Fp = make_c2c(N, 8, P1=4)
    Fs = slab.C2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double")
    u = (rng.standard_normal((N, N, N))
         + 1j * rng.standard_normal((N, N, N))).astype(np.complex128)
    a = np.asarray(Fp.fftn(Fp.shard_real(u)))
    b = np.asarray(Fs.fftn(Fs.shard_real(u)))
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-12


def test_pencil_c2c_divisibility_guard():
    # N2 = 18 not divisible by P2 = 4 → loud error, not silent padding
    with pytest.raises(Exception, match="N2|divis"):
        pencil.C2C(np.array([16, 16, 18]), np.array([TAU] * 3), 8, "double",
                   P1=2)


def test_pencil_c2c_wavenumbers():
    FFT = make_c2c(16, 8, P1=2)
    K = np.asarray(FFT.get_local_wavenumbermesh())
    # signed fft-layout wavenumbers on ALL THREE axes (Hermitian axis is full)
    ref = np.meshgrid(*(np.fft.fftfreq(16, 1 / 16),) * 3, indexing="ij")
    assert np.array_equal(K, np.stack(ref))
