"""Misuse must fail loudly with actionable messages (reference parity:
mpiFFT4py's divisibility asserts; plus this framework's own gates)."""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil, line

TAU = 2 * np.pi
L3 = np.array([TAU] * 3)


def test_slab_indivisible_grid_raises():
    with pytest.raises(Exception, match="divisible|slab"):
        slab.R2C(np.array([12, 12, 12]), L3, 8, "single")


def test_odd_grid_raises():
    with pytest.raises(ValueError, match="even"):
        slab.R2C(np.array([15, 16, 16]), L3, 1, "single")


def test_pencil_bad_alignment_raises():
    with pytest.raises(ValueError, match="alignment"):
        pencil.R2C(np.array([16, 16, 16]), L3, 4, "single", alignment="Z")


def test_unknown_communication_raises():
    with pytest.raises(ValueError, match="communication"):
        slab.R2C(np.array([16, 16, 16]), L3, 1, "single",
                 communication="bogus")


def test_unknown_precision_raises():
    with pytest.raises(Exception):
        slab.R2C(np.array([16, 16, 16]), L3, 1, "quad")


def test_bad_padsize_raises():
    # padsize*N must be integral
    with pytest.raises(ValueError, match="padsize|integral"):
        slab.R2C(np.array([10, 10, 10]), L3, 1, "single", padsize=1.55)


def test_padded_transform_divisibility_check():
    # M = 1.5*N must still divide across the mesh for 3/2-rule
    # (N=8, P=8: M=12 is not divisible by 8)
    FFT = slab.R2C(np.array([8, 8, 8]), L3, 8, "single")
    with pytest.raises(Exception, match="divisible|padded"):
        FFT.forward_fn("3/2-rule")


def test_unknown_dealias_is_silent_none():
    """Reference behavior: dealias strings other than the two rules fall
    through to the undealiased path — document via test (fftn works)."""
    FFT = line.R2C(np.array([16, 16]), np.array([TAU] * 2), 1, "double")
    u = np.random.default_rng(0).standard_normal((16, 16))
    fu = np.asarray(FFT.fft2(u))
    assert np.allclose(fu[:, :FFT.Nf], np.fft.rfft2(u), atol=1e-10)
