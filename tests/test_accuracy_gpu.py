"""Accuracy targets on the GPU, in BASELINE's units (max RELATIVE error).

BASELINE targets: <1e-6 relative (fp32), <1e-12 (fp64).  These tests need
the card; on the CPU test mesh they skip (the decision is made inside the
``gpu`` fixture, never at import).  Run them on a GPU machine with:

    python -m pytest tests/test_accuracy_gpu.py -m gpu -q -p no:cacheprovider --noconftest

(``--noconftest`` keeps tests/conftest.py from forcing the CPU backend.)
"""

import numpy as np
import pytest

import jax

TAU = 2 * np.pi

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {dev.platform!r}")
    return dev


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("N", [64, 256])
def test_slab_fp32_relative_targets(gpu, N):
    from mpifft4py_tpu.slab import R2C
    FFT = R2C(np.array([N] * 3), np.array([TAU] * 3), [gpu], "single")
    u = np.random.default_rng(0).standard_normal((N,) * 3).astype(np.float32)
    fu = FFT.fftn(u)
    assert _rel(FFT.gather(fu), np.fft.rfftn(u.astype(np.float64))) < 1e-6
    assert _rel(FFT.gather(FFT.ifftn(fu)), u) < 1e-6


def test_native_fp64_relative_targets(gpu):
    from mpifft4py_tpu.slab import R2C
    jax.config.update("jax_enable_x64", True)
    N = 64
    FFT = R2C(np.array([N] * 3), np.array([TAU] * 3), [gpu], "double")
    assert FFT.policy.path == "native" and FFT.float == np.float64
    u = np.random.default_rng(1).standard_normal((N,) * 3)
    fu = FFT.fftn(u)
    assert _rel(FFT.gather(fu), np.fft.rfftn(u)) < 1e-12
    assert _rel(FFT.gather(FFT.ifftn(fu)), u) < 1e-12


def test_line_fp32_relative_target(gpu):
    from mpifft4py_tpu.line import R2C
    N = 512
    FFT = R2C(np.array([N, N]), np.array([TAU, TAU]), [gpu], "single")
    u = np.random.default_rng(2).standard_normal((N, N)).astype(np.float32)
    fu = FFT.fft2(u)
    ref = np.fft.rfft2(u.astype(np.float64))
    assert _rel(FFT.gather(fu)[:, :FFT.Nf], ref) < 1e-6
    assert _rel(FFT.gather(FFT.ifft2(fu)), u) < 1e-6


@pytest.mark.parametrize("kind", ["slab", "pencil"])
def test_c2c_fp32_relative_targets(gpu, kind):
    from mpifft4py_tpu import pencil, slab
    N = 128
    grid, L = np.array([N] * 3), np.array([TAU] * 3)
    FFT = (slab.C2C(grid, L, [gpu], "single") if kind == "slab"
           else pencil.C2C(grid, L, [gpu], "single", P1=1))
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((N,) * 3)
         + 1j * rng.standard_normal((N,) * 3)).astype(np.complex64)
    fu = FFT.fftn(FFT.shard_real(u))
    assert _rel(FFT.gather(fu), np.fft.fftn(u.astype(np.complex128))) < 1e-6
    assert _rel(FFT.gather(FFT.ifftn(fu)), u) < 1e-6


def test_pencil_r2c_fp32_relative_targets(gpu):
    from mpifft4py_tpu import pencil
    N = 128
    FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), [gpu], "single",
                     P1=1)
    u = np.random.default_rng(4).standard_normal((N,) * 3).astype(np.float32)
    fu = FFT.fftn(FFT.shard_real(u))
    ref = np.fft.rfftn(u.astype(np.float64))
    assert _rel(FFT.gather(fu)[..., :N // 2 + 1], ref) < 1e-6
    assert _rel(FFT.gather(FFT.ifftn(fu)), u) < 1e-6


@pytest.mark.parametrize("model", ["ns", "vv", "mhd", "bq"])
def test_solver_fp32_step_matches_fp64_on_card(gpu, model):
    """One RK4 step of each 3-D solver at 32³: float32 against float64, both
    on the card."""
    import family_cases as fc
    from mpifft4py_tpu import slab
    jax.config.update("jax_enable_x64", True)
    N = 32

    def step(precision):
        FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), [gpu], precision)
        s = fc.make_solver(model, FFT, "RK4")
        return np.asarray(s.step(fc.initial_state(model, s)), np.complex128)

    lo, hi = step("single"), step("double")
    assert np.isfinite(lo).all()
    assert np.abs(lo - hi).max() < 1e-5 * np.abs(hi).max()


def test_ns2d_fp32_step_matches_fp64_on_card(gpu):
    from mpifft4py_tpu import line
    from mpifft4py_tpu.models.navier_stokes_2d import NavierStokes2D
    jax.config.update("jax_enable_x64", True)
    N = 256

    def step(precision):
        FFT = line.R2C(np.array([N, N]), np.array([TAU, TAU]), [gpu], precision)
        s = NavierStokes2D(FFT, nu=1e-3, dt=1e-3)
        return np.asarray(s.step(s.vortex_pair()), np.complex128)

    lo, hi = step("single"), step("double")
    assert np.isfinite(lo).all()
    assert np.abs(lo - hi).max() < 1e-5 * np.abs(hi).max()
