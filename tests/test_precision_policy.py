"""``resolve_precision`` across backends, x64 settings and ``fp64_mode``.

"double" resolves to native float64 whenever x64 is on, on the CPU and the
GPU alike; without x64 "auto" falls back to the doubleword emulation and
"native" refuses.  The backend is monkeypatched, so both are covered here.
"""

import numpy as np
import pytest

import jax

from mpifft4py_tpu import mpibase
from mpifft4py_tpu.mpibase import resolve_precision

NATIVE = ("native", np.float64, np.complex128)
DOUBLEWORD = ("doubleword", np.float32, np.complex64)

EXPECTED = {
    # (x64, fp64_mode) -> (path, float, complex), or ValueError
    (True, "auto"): NATIVE,
    (True, "native"): NATIVE,
    (True, "doubleword"): DOUBLEWORD,
    (False, "auto"): DOUBLEWORD,
    (False, "native"): ValueError,
    (False, "doubleword"): DOUBLEWORD,
}


@pytest.mark.parametrize("fp64_mode", ["auto", "native", "doubleword"])
@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_double_policy(monkeypatch, backend, x64, fp64_mode):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(mpibase, "_x64_enabled", lambda: x64)
    want = EXPECTED[(x64, fp64_mode)]
    if want is ValueError:
        with pytest.raises(ValueError, match="jax_enable_x64") as e:
            resolve_precision("double", fp64_mode)
        assert "TPU" not in str(e.value)
        return
    pol = resolve_precision("double", fp64_mode)
    assert (pol.path, pol.float, pol.complex) == want
    assert pol.precision == "double"
    assert pol.eps == (2.0 ** -48 if pol.path == "doubleword"
                       else np.finfo(np.float64).eps)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_single_is_float32_everywhere(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    pol = resolve_precision("single")
    assert (pol.path, pol.float, pol.complex) == ("native", np.float32,
                                                  np.complex64)


def test_bad_fp64_mode_raises():
    with pytest.raises(ValueError, match="fp64_mode"):
        resolve_precision("double", "quad")
