"""MHD consumer model: induction + Lorentz coupling over the transform engine.

spectralDNS shipped an MHD solver on the reference transforms; these tests
check this analog's invariants: exact solenoidality of both fields,
ideal total-energy conservation, viscous/resistive decay, and slab/pencil
decomposition agreement.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil
from mpifft4py_tpu.models.mhd import MHD3D

TAU = 2 * np.pi


def _mhd(kind="slab", P=1, nu=1e-3, eta=1e-3, integrator="RK4"):
    N = np.array([16, 16, 16])
    L = np.array([TAU] * 3)
    if kind == "slab":
        FFT = slab.R2C(N, L, P, "double")
    else:
        FFT = pencil.R2C(N, L, P, "double", P1=2)
    return MHD3D(FFT, nu=nu, eta=eta, dt=0.005, integrator=integrator)


@pytest.mark.parametrize("kind,P", [("slab", 1), ("slab", 4), ("pencil", 8)])
def test_mhd_decay_and_solenoidal(kind, P):
    s = _mhd(kind, P)
    UB = s.taylor_green_mhd()
    eu0, eb0 = s.energies(UB)
    assert eu0 > 0 and eb0 > 0
    UB = s.step(s.step(UB))
    eu, eb = s.energies(UB)
    assert np.isfinite(eu) and np.isfinite(eb)
    # dissipative run: total energy decays
    assert eu + eb < eu0 + eb0
    du, db = s.divergences(UB)
    scale = float(np.abs(np.asarray(UB)).max())
    assert du < 1e-10 * scale and db < 1e-10 * scale


def test_mhd_ideal_energy_conserved():
    """nu = eta = 0: total (kinetic+magnetic) energy is a quadratic invariant
    of the dealiased semi-discrete system; RK4 drift is O(dt^5)."""
    s = _mhd(nu=0.0, eta=0.0)
    UB = s.taylor_green_mhd()
    eu0, eb0 = s.energies(UB)
    for _ in range(3):
        UB = s.step(UB)
    eu, eb = s.energies(UB)
    assert abs((eu + eb) - (eu0 + eb0)) < 1e-9
    # and energy EXCHANGES between fields (coupling is live)
    assert abs(eb - eb0) > 1e-12


def test_mhd_slab_pencil_agree():
    s1 = _mhd("slab", 4)
    s2 = _mhd("pencil", 8)
    U1 = s1.step(s1.taylor_green_mhd())
    U2 = s2.step(s2.taylor_green_mhd())
    a = np.asarray(U1)
    b = np.asarray(U2)[..., :s2.FFT.Nf]
    assert np.allclose(a, b, atol=1e-10)


def test_mhd_integrators_and_run():
    rk4 = _mhd(integrator="RK4")
    ls = _mhd(integrator="LSRK54")
    U1 = rk4.step(rk4.taylor_green_mhd())
    U2 = ls.step(ls.taylor_green_mhd())
    assert np.allclose(np.asarray(U1), np.asarray(U2), atol=1e-9)
    U3 = rk4.run(rk4.taylor_green_mhd(), 2)
    eu, eb = rk4.energies(U3)
    assert np.isfinite(eu) and np.isfinite(eb)


def test_mhd_zero_field_reduces_to_ns():
    """b = 0: the momentum equation reduces exactly to Navier–Stokes."""
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D

    N = np.array([16, 16, 16])
    L = np.array([TAU] * 3)
    FFT = slab.R2C(N, L, 1, "double")
    ns = NavierStokes3D(FFT, nu=1e-3, dt=0.005)
    mh = MHD3D(FFT, nu=1e-3, eta=1e-3, dt=0.005)
    U_hat = ns.taylor_green()
    UB = np.concatenate([np.asarray(U_hat), np.zeros_like(np.asarray(U_hat))])
    U1 = ns.step(U_hat)
    UB1 = mh.step(UB)
    assert np.allclose(np.asarray(UB1)[:3], np.asarray(U1), atol=1e-12)
    assert np.abs(np.asarray(UB1)[3:]).max() == 0.0
