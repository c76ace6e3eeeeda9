"""Debug-mode and self-validation utilities (SURVEY §5 aux subsystem)."""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil, line
from mpifft4py_tpu.utils.debug import validate, debug_mode

TAU = 2 * np.pi


@pytest.mark.parametrize("make", [
    lambda: slab.R2C(np.array([16] * 3), np.array([TAU] * 3), 4, "double"),
    lambda: pencil.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "double", P1=2),
    lambda: pencil.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "double",
                       P1=2, alignment="Y"),
    lambda: line.R2C(np.array([32, 32]), np.array([TAU] * 2), 4, "double"),
])
def test_validate_all_decompositions(make):
    rep = validate(make())
    assert rep["roundtrip"] < 1e-12, rep
    assert rep["linearity"] < 1e-13, rep
    assert rep["parseval"] < 1e-6, rep   # f32 accumulation in the check itself


def test_debug_mode_traps_nans():
    import jax
    import jax.numpy as jnp

    with debug_mode():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.zeros(4) - 1.0).block_until_ready()


def test_stage_report(rng):
    from mpifft4py_tpu import slab
    from mpifft4py_tpu.utils.profiling import stage_report

    FFT = slab.R2C(np.array([16] * 3), np.array([2 * np.pi] * 3), 4, "single")
    rep = stage_report(FFT, iters=2)
    assert rep["roundtrip_ms"] > 0
    assert rep["collectives_per_roundtrip"] == 2
    assert rep["a2a_bytes_per_device"] > 0


def test_stage_report_padded(rng):
    """Regression (r2 review): dealias='3/2-rule' round trip is M-grid
    preserving; stage_report must feed it the padded grid."""
    from mpifft4py_tpu import slab
    from mpifft4py_tpu.utils.profiling import stage_report

    FFT = slab.R2C(np.array([16] * 3), np.array([2 * np.pi] * 3), 4, "single")
    rep = stage_report(FFT, dealias="3/2-rule", iters=2)
    assert rep["roundtrip_ms"] > 0
