"""Velocity–vorticity solver: mutual-oracle tests against the velocity form.

In exact arithmetic curl(NS trajectory) == VV trajectory (curl kills the
Leray projection's gradient part), so the two independently-implemented
solvers validate each other to round-off.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
from mpifft4py_tpu.models.vv import VorticityVelocity3D

TAU = 2 * np.pi


def _pair(kind="slab", P=1):
    N = np.array([16, 16, 16])
    L = np.array([TAU] * 3)
    if kind == "slab":
        FFT = slab.R2C(N, L, P, "double")
    else:
        FFT = pencil.R2C(N, L, P, "double", P1=2)
    ns = NavierStokes3D(FFT, nu=1e-3, dt=0.005, dealias="2/3-rule")
    vv = VorticityVelocity3D(FFT, nu=1e-3, dt=0.005, dealias="2/3-rule")
    return ns, vv


@pytest.mark.parametrize("kind,P", [("slab", 1), ("slab", 4), ("pencil", 8)])
def test_vv_matches_curl_of_ns(kind, P):
    ns, vv = _pair(kind, P)
    U0 = ns.taylor_green()
    W0 = vv.from_velocity(U0)
    U1 = ns.step(U0)
    W1 = vv.step(W0)
    ref = np.asarray(vv.from_velocity(U1))
    got = np.asarray(W1)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-10 * max(scale, 1.0)


def test_vv_velocity_roundtrip():
    """Biot–Savart inverts the curl on solenoidal fields."""
    ns, vv = _pair()
    U0 = ns.taylor_green()
    U_back = np.asarray(vv.velocity(vv.from_velocity(U0)))
    assert np.allclose(U_back, np.asarray(U0), atol=1e-12)


def test_vv_energy_decay_and_enstrophy():
    _, vv = _pair()
    W = vv.taylor_green()
    e0, z0 = vv.energy(W), vv.enstrophy(W)
    assert abs(e0 - 0.125) < 1e-10
    for _ in range(3):
        W = vv.step(W)
    e1 = vv.energy(W)
    assert 0 < e1 < e0
    assert np.isfinite(vv.enstrophy(W)) and z0 > 0


def test_vv_integrators():
    N = np.array([16, 16, 16])
    FFT = slab.R2C(N, np.array([TAU] * 3), 1, "double")
    rk4 = VorticityVelocity3D(FFT, nu=1e-3, dt=0.005)
    ls = VorticityVelocity3D(FFT, nu=1e-3, dt=0.005, integrator="LSRK54")
    W1 = rk4.step(rk4.taylor_green())
    W2 = ls.step(ls.taylor_green())
    assert np.allclose(np.asarray(W1), np.asarray(W2), atol=1e-9)
    W3 = rk4.run(rk4.taylor_green(), 2)
    assert np.isfinite(rk4.energy(W3))
