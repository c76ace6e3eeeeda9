"""Boussinesq convection: Navier–Stokes + buoyant temperature transport.

spectralDNS's Boussinesq solver family analog over the same transform engine.
Momentum gets a buoyancy force Ri·θ in the (last-axis) gravity direction;
temperature is advected in conservative form (incompressibility makes
u·∇θ = ∇·(uθ)) so the spectral divergence is exact:

    ∂û/∂t = P[ F(u×ω) + Ri θ̂ ê_g ] − ν k² û
    ∂θ̂/∂t = − i k · F(u θ) − κ k² θ̂

State: stacked (4,) + global_complex_shape() — components 0..2 = û, 3 = θ̂ —
so the shared integrator set applies unchanged.  13 distributed transforms
per RHS.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .navier_stokes import SpectralSolver


class Boussinesq3D(SpectralSolver):
    """Buoyancy-coupled pseudo-spectral solver over a slab/pencil R2C.

    Args:
      nu: viscosity; kappa: scalar diffusivity; Ri: Richardson number
      (buoyancy strength); gravity along axis 2 (the z axis).
    """

    def __init__(self, FFT, nu: float, kappa: float, dt: float, Ri: float = 1.0,
                 dealias: Optional[str] = "2/3-rule", integrator: str = "RK4"):
        self.nu = float(nu)
        self.kappa = float(kappa)
        self.Ri = float(Ri)
        self._init_solver(FFT, dt, dealias, integrator)

    # -- initial conditions -------------------------------------------------------

    def taylor_green_stratified(self, theta0: float = 0.1):
        """TG velocity + θ = theta0·sin(z) perturbation: stacked (4,)+spectral."""
        X = self.FFT.get_local_mesh()

        def init(X):
            u = jnp.stack([
                jnp.sin(X[0]) * jnp.cos(X[1]) * jnp.cos(X[2]),
                -jnp.cos(X[0]) * jnp.sin(X[1]) * jnp.cos(X[2]),
                jnp.zeros_like(X[0]),
            ])
            th = theta0 * jnp.sin(X[2])
            return jnp.stack([self._fwd_plain(u[i]) for i in range(3)]
                             + [self._fwd_plain(th)])
        return jax.jit(init)(X)

    def rest_state(self, theta0: float = 0.1):
        """u = 0, θ = theta0·sin(z): buoyancy is a pure gradient, so the
        projected dynamics keep the fluid exactly at rest (test invariant)."""
        X = self.FFT.get_local_mesh()

        def init(X):
            z = jnp.zeros_like(X[0])
            th = theta0 * jnp.sin(X[2])
            return jnp.stack([self._fwd_plain(z)] * 3 + [self._fwd_plain(th)])
        return jax.jit(init)(X)

    # -- dynamics ----------------------------------------------------------------

    def rhs(self, S_hat, k0, k1, k2):
        bwd, fwd = self._bwd_nl, self._fwd
        K0 = k0[:, None, None]
        K1 = k1[None, :, None]
        K2v = k2[None, None, :]
        U_hat, T_hat = S_hat[:3], S_hat[3]
        U = jnp.stack([bwd(U_hat[i]) for i in range(3)])
        th = bwd(T_hat)
        cu0 = 1j * (K1 * U_hat[2] - K2v * U_hat[1])
        cu1 = 1j * (K2v * U_hat[0] - K0 * U_hat[2])
        cu2 = 1j * (K0 * U_hat[1] - K1 * U_hat[0])
        W = jnp.stack([bwd(cu0), bwd(cu1), bwd(cu2)])
        F0 = U[1] * W[2] - U[2] * W[1]
        F1 = U[2] * W[0] - U[0] * W[2]
        F2 = U[0] * W[1] - U[1] * W[0]
        F_hat = jnp.stack([fwd(F0), fwd(F1), fwd(F2)])
        # buoyancy Ri·θ ê_z joins the force BEFORE projection
        F_hat = F_hat.at[2].add(self.Ri * T_hat)
        ksq = K0 * K0 + K1 * K1 + K2v * K2v
        div = (K0 * F_hat[0] + K1 * F_hat[1] + K2v * F_hat[2]) \
            / jnp.where(ksq == 0, 1, ksq)
        dU = F_hat - jnp.stack([K0 * div, K1 * div, K2v * div]) \
            - self.nu * ksq[None] * U_hat
        # conservative scalar flux: dθ̂ = −i k·F(uθ) − κ k² θ̂
        G_hat = jnp.stack([fwd(U[i] * th) for i in range(3)])
        dT = -1j * (K0 * G_hat[0] + K1 * G_hat[1] + K2v * G_hat[2]) \
            - self.kappa * ksq * T_hat
        return jnp.concatenate([dU, dT[None]])

    # step_fn/ab2_state/step/run: inherited from SpectralSolver

    # -- diagnostics ---------------------------------------------------------------

    def energies(self, S_hat):
        """(kinetic, scalar-variance) means: 0.5<|u|²>, 0.5<θ²>."""
        def build():
            def ke(S_hat):
                U = jnp.stack([self._bwd(S_hat[i]) for i in range(3)])
                th = self._bwd(S_hat[3])
                sm = SpectralSolver.staged_mean
                return (0.5 * sm(jnp.sum(U * U, axis=0)),
                        0.5 * sm(th * th))
            return ke
        eu, et = self._plan("energies", build)(S_hat)
        return float(eu), float(et)
