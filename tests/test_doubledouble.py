"""Double-word (emulated fp64) tier: dd arithmetic, dd FFTs, slab integration.

Accuracy notes: at 64³ on an NVIDIA H100 the doubleword path measured
6.7e-15 relative forward and 8.7e-15 round trip (chip_smoke.py phase 3),
inside BASELINE's <1e-12.  On the CPU *test* backend, XLA's fusion-level FMA
contraction degrades jitted dd composites to ~1e-7, so jit-level tests here
assert plumbing at loose tolerance and exact accuracy is asserted in eager
mode (no fusion).  "double" resolves to native f64 whenever x64 is on;
"doubleword" is selected explicitly with fp64_mode.
"""

import numpy as np
import pytest

import jax

from mpifft4py_tpu.ops.doubledouble import DD, DDComplex
from mpifft4py_tpu.ops import dd_fft as df
from mpifft4py_tpu import slab

TAU = 2 * np.pi


def test_dd_arithmetic_exactness(rng):
    a64 = rng.standard_normal(4096)
    b64 = rng.standard_normal(4096)
    a, b = DD.from_f64(a64), DD.from_f64(b64)
    assert np.abs(a.to_f64() - a64).max() < 2e-14  # ~2^-48 representation error
    assert np.abs((a + b).to_f64() - (a64 + b64)).max() < 1e-13
    assert np.abs((a * b).to_f64() - (a64 * b64)).max() < 1e-13
    assert np.abs((a - b).to_f64() - (a64 - b64)).max() < 1e-13


@pytest.mark.parametrize("n", [16, 96, 128, 256, 384])
def test_dd_fft_eager_accuracy(rng, n):
    """Eager mode (no XLA fusion) hits near-dd accuracy on every size class."""
    with jax.disable_jit():
        x64 = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
        out = df.fft_dd(DDComplex.from_c128(x64)).to_c128()
        ref = np.fft.fft(x64)
        assert np.abs(out - ref).max() / np.abs(ref).max() < 5e-14
        back = df.ifft_dd(df.fft_dd(DDComplex.from_c128(x64))).to_c128()
        assert np.abs(back - x64).max() < 5e-13
        xr = rng.standard_normal((2, n))
        o = df.rfft_dd(DD.from_f64(xr)).to_c128()
        rr = np.fft.rfft(xr)
        assert np.abs(o - rr).max() / np.abs(rr).max() < 5e-14
        bk = df.irfft_dd(DDComplex.from_c128(rr), n=n).to_f64()
        assert np.abs(bk - xr).max() < 5e-13


def test_dd_fft_jit_plumbing(rng):
    """Under jit on CPU, fusion FMA contraction caps accuracy ~1e-7 — assert
    the plumbing works and stays well above float32-roundtrip garbage."""
    n = 256
    x64 = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    out = jax.jit(df.fft_dd)(DDComplex.from_c128(x64)).to_c128()
    ref = np.fft.fft(x64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-6


@pytest.mark.parametrize("P", [1, 4])
def test_slab_doubleword_roundtrip(rng, P):
    """slab.R2C with the doubleword path (selected via fp64_mode)."""
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), P, "double",
                   fp64_mode="doubleword")
    assert FFT.policy.path == "doubleword"
    u64 = rng.standard_normal((N, N, N))
    fu = FFT.fftn(u64)
    out = FFT.gather_dd(fu)
    ref = np.fft.rfftn(u64)
    # jit-on-CPU tolerance (see module docstring)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    ub = FFT.gather_dd(FFT.ifftn(fu))
    assert np.abs(ub - u64).max() < 1e-5


def test_slab_doubleword_dealias_and_padded(rng):
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 2, "double",
                   fp64_mode="doubleword")
    u64 = rng.standard_normal((N, N, N))
    fu23 = FFT.fftn(u64, dealias="2/3-rule")
    out = FFT.gather_dd(fu23)
    assert out.shape == FFT.global_complex_shape()
    # padded roundtrip
    fu = FFT.fftn(u64)
    up = FFT.ifftn(fu, dealias="3/2-rule")
    assert up.shape == FFT.global_real_shape_padded()
    fu2 = FFT.gather_dd(FFT.fftn(up, dealias="3/2-rule"))
    assert np.abs(fu2 - FFT.gather_dd(fu)).max() < 1e-4 * N ** 3


def test_slab_c2c_doubleword(rng):
    N = 16
    FFT = slab.C2C(np.array([N] * 3), np.array([TAU] * 3), 2, "double",
                   fp64_mode="doubleword")
    u64 = rng.standard_normal((N, N, N)) + 1j * rng.standard_normal((N, N, N))
    fu = FFT.fftn(u64)
    out = FFT.gather_dd(fu)
    ref = np.fft.fftn(u64)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5
    ub = FFT.gather_dd(FFT.ifftn(fu))
    assert np.abs(ub - u64).max() < 1e-5


@pytest.mark.parametrize("P1", [2])
def test_pencil_doubleword_roundtrip(rng, P1):
    from mpifft4py_tpu import pencil

    N = 16
    FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double",
                     P1=P1, fp64_mode="doubleword")
    u64 = rng.standard_normal((N, N, N))
    fu = FFT.fftn(u64)
    out = FFT.gather_dd(fu)
    ref = np.fft.rfftn(u64)
    assert np.abs(out[..., :FFT.Nf] - ref).max() / np.abs(ref).max() < 1e-5
    ub = FFT.gather_dd(FFT.ifftn(fu))
    assert np.abs(ub - u64).max() < 1e-5
    # padded roundtrip
    up = FFT.ifftn(fu, dealias="3/2-rule")
    fu2 = FFT.gather_dd(FFT.fftn(up, dealias="3/2-rule"))
    assert np.abs(fu2 - out).max() < 1e-4 * N ** 3


@pytest.mark.parametrize("communication", ["Alltoall", "pipelined"])
def test_pencil_y_doubleword_roundtrip(rng, communication):
    """alignment='Y' x doubleword (x pipelined)."""
    from mpifft4py_tpu import pencil

    N = 16
    FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double",
                     P1=2, alignment="Y", fp64_mode="doubleword",
                     communication=communication, pipeline_chunks=3)
    assert FFT.policy.path == "doubleword"
    u64 = rng.standard_normal((N, N, N))
    fu = FFT.fftn(u64)
    out = FFT.gather_dd(fu)
    ref = np.fft.rfftn(u64)
    assert np.abs(out[..., :FFT.Nf] - ref).max() / np.abs(ref).max() < 1e-5
    ub = FFT.gather_dd(FFT.ifftn(fu))
    assert np.abs(ub - u64).max() < 1e-5
    # padded roundtrip through the Y choreography
    up = FFT.ifftn(fu, dealias="3/2-rule")
    fu2 = FFT.gather_dd(FFT.fftn(up, dealias="3/2-rule"))
    assert np.abs(fu2 - out).max() < 1e-4 * N ** 3


def test_line_doubleword_roundtrip(rng):
    from mpifft4py_tpu import line

    N = 32
    FFT = line.R2C(np.array([N, N]), np.array([TAU, TAU]), 4, "double",
                   fp64_mode="doubleword")
    u64 = rng.standard_normal((N, N))
    fu = FFT.fft2(u64)
    out = FFT.gather_dd(fu)
    ref = np.fft.rfft2(u64)
    assert np.abs(out[:, :FFT.Nf] - ref).max() / np.abs(ref).max() < 1e-5
    ub = FFT.gather_dd(FFT.ifft2(fu))
    assert np.abs(ub - u64).max() < 1e-5
