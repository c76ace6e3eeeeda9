"""Matmul (four-step einsum) FFT kernels vs numpy — every size in the plan table.

Sizes cover powers of two, the 3/2-rule padded grids (3·2^k), odd radices, and
primes (single dense-DFT fallback).
"""

import numpy as np
import pytest

from mpifft4py_tpu.ops import fft_core as fc

SIZES = [16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]


@pytest.mark.parametrize("n", SIZES)
def test_c2c_matches_numpy(rng, n):
    x = (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n)))
    ref = np.fft.fft(x, axis=-1)
    out = np.asarray(fc.fft_matmul(x, axis=-1))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12
    back = np.asarray(fc.ifft_matmul(out, axis=-1))
    assert np.abs(back - x).max() < 1e-12


@pytest.mark.parametrize("n", [15, 17, 30])  # primes / odd composites
def test_c2c_odd_sizes(rng, n):
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    out = np.asarray(fc.fft_matmul(x))
    assert np.allclose(out, np.fft.fft(x), atol=1e-11)


@pytest.mark.parametrize("n", SIZES)
def test_r2c_matches_numpy(rng, n):
    x = rng.standard_normal((5, n))
    ref = np.fft.rfft(x, axis=-1)
    out = np.asarray(fc.rfft_matmul(x, axis=-1))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-12
    back = np.asarray(fc.irfft_matmul(out, axis=-1, n=n))
    assert np.abs(back - x).max() < 1e-12


def test_axis_argument(rng):
    x = rng.standard_normal((8, 12, 16)) + 0j
    for ax in (0, 1, 2, -1):
        assert np.allclose(np.asarray(fc.fft_matmul(x, axis=ax)),
                           np.fft.fft(x, axis=ax), atol=1e-11)
    xr = rng.standard_normal((8, 12, 16))
    for ax in (0, 1):
        assert np.allclose(np.asarray(fc.rfft_matmul(xr, axis=ax)),
                           np.fft.rfft(xr, axis=ax), atol=1e-11)
        nf = np.fft.rfft(xr, axis=ax)
        assert np.allclose(np.asarray(fc.irfft_matmul(nf, axis=ax, n=xr.shape[ax])),
                           xr, atol=1e-12)


def test_f32_accuracy(rng):
    """fp32 path must stay well under the 1e-6 relative target (HIGHEST precision)."""
    n = 256
    x = rng.standard_normal((32, n)).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    out = np.asarray(fc.rfft_matmul(x, axis=-1))
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel < 1e-6, rel


def test_dispatch_override(rng, monkeypatch):
    monkeypatch.setenv("MPIFFT4PY_TPU_FFT_BACKEND", "matmul")
    assert fc.use_matmul_fft(256)
    monkeypatch.setenv("MPIFFT4PY_TPU_FFT_BACKEND", "xla")
    assert not fc.use_matmul_fft(256)
    monkeypatch.delenv("MPIFFT4PY_TPU_FFT_BACKEND")
    # XLA's FFT is the default
    assert not fc.use_matmul_fft(256)
    assert not fc.use_matmul_fft(4096)
