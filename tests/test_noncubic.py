"""Non-cubic grids and anisotropic domains — axis-mixup hunting.

Cubic test grids hide transposition bugs (every axis has the same length);
the reference supports arbitrary N = [N0, N1, N2] and L. These tests use
pairwise-distinct dims everywhere.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil, line

TAU = 2 * np.pi


@pytest.mark.parametrize("P", [1, 4])
def test_slab_noncubic(rng, P):
    N = np.array([16, 32, 8])
    FFT = slab.R2C(N, np.array([1.0, 2.0, 3.0]), P, "double")
    u = rng.standard_normal(tuple(N))
    fu = np.asarray(FFT.fftn(u))
    ref = np.fft.rfftn(u)
    assert fu.shape == (16, 32, 5)
    assert np.allclose(fu, ref, atol=1e-10)
    assert np.allclose(np.asarray(FFT.ifftn(FFT.shard_complex(fu))), u, atol=1e-12)
    # padded: distinct M = (24, 48, 12)
    up = FFT.ifftn(FFT.shard_complex(fu), dealias="3/2-rule")
    assert up.shape == (24, 48, 12)
    fu2 = np.asarray(FFT.fftn(up, dealias="3/2-rule"))
    assert np.allclose(fu2, fu, atol=1e-10 * np.prod(N))


@pytest.mark.parametrize("alignment", ["X", "Y"])
def test_pencil_noncubic(rng, alignment):
    N = np.array([16, 32, 8])
    FFT = pencil.R2C(N, np.array([1.0, 2.0, 3.0]), 8, "double", P1=2,
                     alignment=alignment)
    u = rng.standard_normal(tuple(N))
    fu = np.asarray(FFT.fftn(u))
    ref = np.fft.rfftn(u)
    assert np.allclose(fu[..., :FFT.Nf], ref, atol=1e-10)
    assert np.allclose(np.asarray(FFT.ifftn(FFT.shard_complex(fu))), u, atol=1e-12)


def test_line_nonsquare(rng):
    N = np.array([16, 64])
    FFT = line.R2C(N, np.array([1.0, 2.0]), 4, "double")
    u = rng.standard_normal(tuple(N))
    fu = np.asarray(FFT.fft2(u))
    assert np.allclose(fu[:, :FFT.Nf], np.fft.rfft2(u), atol=1e-10)
    assert np.allclose(np.asarray(FFT.ifft2(FFT.shard_complex(fu))), u, atol=1e-12)


def test_scaled_wavenumbers_anisotropic():
    """K_i = 2π k_i / L_i — distinct L per axis must scale independently."""
    N = np.array([8, 16, 32])
    L = np.array([1.0, 4.0, TAU])
    FFT = slab.R2C(N, L, 2, "double")
    Ks = np.asarray(FFT.get_scaled_local_wavenumbermesh())
    k0 = np.fft.fftfreq(8, 1 / 8) * 2 * np.pi / 1.0
    k1 = np.fft.fftfreq(16, 1 / 16) * 2 * np.pi / 4.0
    k2 = np.arange(17) * 2 * np.pi / TAU
    assert np.allclose(Ks[0][:, 0, 0], k0)
    assert np.allclose(Ks[1][0, :, 0], k1)
    assert np.allclose(Ks[2][0, 0, :], k2)
    # spectral derivative oracle: d/dx1 sin(2π·3·x1/L1) = (6π/L1)cos(...)
    X = np.asarray(FFT.get_local_mesh())
    u = np.sin(2 * np.pi * 3 * X[1] / L[1])
    fu = FFT.fftn(u)
    du = np.asarray(FFT.ifftn(1j * np.asarray(Ks[1]) * np.asarray(fu)))
    ref = (2 * np.pi * 3 / L[1]) * np.cos(2 * np.pi * 3 * X[1] / L[1])
    assert np.abs(du - ref).max() < 1e-8
