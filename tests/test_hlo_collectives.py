"""Collective structure of the compiled transforms, per decomposition and
dealias rule: one all-to-all per direction for slab and line, two for a
pencil with both mesh axes live (one when P1 == 1 — the degenerate axis
skips its collective), and no all-gather/all-reduce/collective-permute
except the 3/2-rule forward's Nyquist-plane gather.  Also: a
single-precision program carries no float64 op even with x64 on (float64
is slow on GPUs, so a stray promotion would be a silent slowdown)."""

import re

import numpy as np
import pytest

import jax

from mpifft4py_tpu import line, pencil, slab
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D

TAU = 2 * np.pi
N = 16

# decomposition -> (constructor, all-to-alls per direction)
CASES = {
    "slab4": (lambda: slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4,
                               "single"), 1),
    "pencil2x2": (lambda: pencil.R2C(np.array([N] * 3), np.array([TAU] * 3),
                                     4, "single", P1=2), 2),
    "pencil1x4": (lambda: pencil.R2C(np.array([N] * 3), np.array([TAU] * 3),
                                     4, "single", P1=1), 1),
    "line4": (lambda: line.R2C(np.array([N] * 2), np.array([TAU] * 2), 4,
                               "single"), 1),
}


def compiled_text(FFT, fn, spectral, padded=False):
    if spectral:
        shape, dt, sh = (FFT.global_complex_shape(), FFT.complex,
                         FFT.complex_sharding())
    else:
        shape = (FFT.global_real_shape_padded() if padded
                 else FFT.global_real_shape())
        dt, sh = FFT.float, FFT.real_sharding()
    x = jax.ShapeDtypeStruct(shape, dt, sharding=sh)
    return jax.jit(fn).lower(x).compile().as_text()


def count(hlo, op):
    return len(re.findall(rf"\s{op}(?:-start)?\(", hlo))


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
@pytest.mark.parametrize("decomp", sorted(CASES))
def test_collective_counts(decomp, dealias, direction):
    make, want = CASES[decomp]
    FFT = make()
    if direction == "forward":
        hlo = compiled_text(FFT, FFT.forward_fn(dealias), spectral=False,
                            padded=dealias == "3/2-rule")
    else:
        hlo = compiled_text(FFT, FFT.backward_fn(dealias), spectral=True)
    assert count(hlo, "all-to-all") == want
    gathers = count(hlo, "all-gather")
    if dealias == "3/2-rule" and direction == "forward" \
            and decomp in ("slab4", "pencil2x2"):
        # the z-Nyquist plane symmetrisation gathers that one plane
        assert gathers == 1
    else:
        assert gathers == 0
    for bad in ("all-reduce", "collective-permute"):
        assert count(hlo, bad) == 0, f"stray {bad}"


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("decomp", sorted(CASES))
def test_single_precision_has_no_f64(decomp, direction):
    make, _ = CASES[decomp]
    FFT = make()
    fn = FFT.forward_fn() if direction == "forward" else FFT.backward_fn()
    hlo = compiled_text(FFT, fn, spectral=direction == "backward")
    assert jax.config.jax_enable_x64          # the hazard needs x64 on
    assert not re.search(r"\b(f64|c128)\[", hlo)


@pytest.mark.parametrize("decomp", ["slab4", "pencil2x2"])
def test_single_precision_dns_step_has_no_f64(decomp):
    FFT = CASES[decomp][0]()
    s = NavierStokes3D(FFT, nu=1e-3, dt=1e-3, dealias="2/3-rule")
    U = jax.ShapeDtypeStruct((3,) + FFT.global_complex_shape(), FFT.complex)
    hlo = jax.jit(s.step_fn()).lower(U, *s._step_args()).compile().as_text()
    assert not re.search(r"\b(f64|c128)\[", hlo)
