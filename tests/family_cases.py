"""Shared cases for the solver-family matrix (test_family_*.py).

Each case takes ONE step of one solver with one integrator at 16³ in float64
on the CPU mesh.  P=1 steps are checked against physics (divergence-free
output and the inviscid energy budget); P>1 steps (slab P=4, pencil 2×2) are
checked against the P=1 step.
"""

import numpy as np

import jax.numpy as jnp

from mpifft4py_tpu import pencil, slab
from mpifft4py_tpu.models.boussinesq import Boussinesq3D
from mpifft4py_tpu.models.mhd import MHD3D
from mpifft4py_tpu.models.navier_stokes import INTEGRATORS, NavierStokes3D
from mpifft4py_tpu.models.vv import VorticityVelocity3D

TAU = 2 * np.pi
N = 16
DT = 1e-3
DECOMPS = ("slab1", "slab4", "pencil2x2")


def make_fft(decomp):
    grid, L = np.array([N] * 3), np.array([TAU] * 3)
    if decomp == "slab1":
        return slab.R2C(grid, L, 1, "double")
    if decomp == "slab4":
        return slab.R2C(grid, L, 4, "double")
    return pencil.R2C(grid, L, 4, "double", P1=2)


# inviscid: every dissipative coefficient is zero, so the P=1 step must keep
# the conserved quantity to the integrator's truncation error
def make_solver(model, FFT, integrator):
    kw = dict(dt=DT, dealias="2/3-rule", integrator=integrator)
    if model == "ns":
        return NavierStokes3D(FFT, nu=0.0, **kw)
    if model == "vv":
        return VorticityVelocity3D(FFT, nu=0.0, **kw)
    if model == "mhd":
        return MHD3D(FFT, nu=0.0, eta=0.0, **kw)
    return Boussinesq3D(FFT, nu=0.0, kappa=0.0, Ri=1.0, **kw)


def initial_state(model, s):
    if model in ("ns", "vv"):
        return s.taylor_green()
    if model == "mhd":
        return s.taylor_green_mhd(b0=0.3)
    return s.taylor_green_stratified(theta0=0.2)


def invariant(model, s, S):
    """The quantity the inviscid dealiased dynamics conserve: kinetic energy
    (NS, VV), kinetic + magnetic energy (MHD), scalar variance (Boussinesq —
    buoyancy exchanges kinetic energy, advection keeps ½<θ²>)."""
    if model == "ns":
        return s.energy(S)
    if model == "vv":
        return s.energy(S)
    if model == "mhd":
        return sum(s.energies(S))
    return s.energies(S)[1]


def divergence(model, s, S):
    """max |k·V̂| / max |V̂| over the solenoidal fields of the state."""
    k0, k1, k2 = s._step_args()
    K = (k0[:, None, None], k1[None, :, None], k2[None, None, :])

    def rel_div(V):
        d = K[0] * V[0] + K[1] * V[1] + K[2] * V[2]
        return float(jnp.abs(d).max() / jnp.abs(V).max())
    S = jnp.asarray(S)
    if model == "mhd":
        return max(rel_div(S[:3]), rel_div(S[3:]))
    return rel_div(S[:3])


def one_step(model, decomp, integrator):
    """(solver, state before, state after) for one step."""
    s = make_solver(model, make_fft(decomp), integrator)
    S0 = initial_state(model, s)
    if integrator == "AB2":
        S1 = s.step(s.ab2_state(S0))[0]
    else:
        S1 = s.step(S0)
    return s, S0, S1


_REF = {}


def reference_step(model, integrator):
    key = (model, integrator)
    if key not in _REF:
        s, _, S1 = one_step(model, "slab1", integrator)
        _REF[key] = np.asarray(S1)
    return _REF[key]


def run_case(model, decomp, integrator):
    s, S0, S1 = one_step(model, decomp, integrator)
    if decomp == "slab1":
        assert divergence(model, s, S1) < 1e-12
        e0, e1 = invariant(model, s, S0), invariant(model, s, S1)
        # Euler/AB2's first step gains O(dt²); RK4 and LSRK54 O(dt⁵)
        tol = 1e-5 if integrator in ("Euler", "AB2") else 1e-10
        assert abs(e1 - e0) <= tol * abs(e0), (e0, e1)
        assert not np.allclose(np.asarray(S1), np.asarray(S0))  # it moved
        return
    ref = reference_step(model, integrator)
    got = np.asarray(S1)[..., :ref.shape[-1]]
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


__all__ = ["DECOMPS", "INTEGRATORS", "run_case"]
