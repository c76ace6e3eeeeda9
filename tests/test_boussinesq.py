"""Boussinesq solver invariants: rest-state preservation (buoyancy gradient
is projected away), reduction to NS at Ri=0 with uniform scalar diffusion,
scalar-variance decay, and slab/pencil agreement."""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil
from mpifft4py_tpu.models.boussinesq import Boussinesq3D
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D

TAU = 2 * np.pi


def _solver(kind="slab", P=1, **kw):
    N = np.array([16, 16, 16])
    L = np.array([TAU] * 3)
    if kind == "slab":
        FFT = slab.R2C(N, L, P, "double")
    else:
        FFT = pencil.R2C(N, L, P, "double", P1=2)
    args = dict(nu=1e-3, kappa=1e-3, dt=0.005, Ri=1.0)
    args.update(kw)
    return Boussinesq3D(FFT, **args)


def test_rest_state_stays_at_rest():
    """θ = sin(z), u = 0: the buoyancy force is ∇(−Ri cos z) — a pure
    gradient — so projection kills it and the fluid never moves, while θ
    decays by pure diffusion."""
    s = _solver()
    S = s.rest_state()
    eu0, et0 = s.energies(S)
    assert eu0 == 0.0
    for _ in range(3):
        S = s.step(S)
    eu, et = s.energies(S)
    assert eu < 1e-28              # still at rest (round-off only)
    # pure diffusion of sin(z): θ(t) = θ0 e^{−κt} ⇒ variance e^{−2κt}
    t = 3 * s.dt
    assert abs(et - et0 * np.exp(-2 * s.kappa * t)) < 1e-12


def test_buoyancy_generates_motion():
    """A horizontally-varying θ (sin x) has a rotational buoyancy component:
    flow must start from rest."""
    s = _solver()
    X = s.FFT.get_local_mesh()
    import jax
    import jax.numpy as jnp
    S = jax.jit(lambda X: jnp.stack(
        [s._fwd_plain(jnp.zeros_like(X[0]))] * 3
        + [s._fwd_plain(0.1 * jnp.sin(X[0]))]))(X)
    S = s.step(S)
    eu, _ = s.energies(S)
    assert eu > 1e-12


def test_ri_zero_velocity_matches_ns():
    """Ri = 0 decouples θ from momentum: velocity evolves exactly as NS."""
    s = _solver(Ri=0.0)
    FFT = s.FFT
    ns = NavierStokes3D(FFT, nu=1e-3, dt=0.005)
    U0 = ns.taylor_green()
    import jax.numpy as jnp
    S0 = jnp.concatenate([U0, 0 * U0[:1]])
    S1 = s.step(S0)
    U1 = ns.step(U0)
    assert np.allclose(np.asarray(S1)[:3], np.asarray(U1), atol=1e-12)


@pytest.mark.parametrize("kind,P", [("slab", 4), ("pencil", 8)])
def test_boussinesq_distributed(kind, P):
    s = _solver(kind, P)
    S = s.step(s.taylor_green_stratified())
    eu, et = s.energies(S)
    assert np.isfinite(eu) and np.isfinite(et) and eu > 0 and et > 0


def test_boussinesq_slab_pencil_agree():
    s1 = _solver("slab", 4)
    s2 = _solver("pencil", 8)
    S1 = s1.step(s1.taylor_green_stratified())
    S2 = s2.step(s2.taylor_green_stratified())
    assert np.allclose(np.asarray(S1), np.asarray(S2)[..., :s2.FFT.Nf],
                       atol=1e-10)
