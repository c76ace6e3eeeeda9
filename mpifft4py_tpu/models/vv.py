"""Velocity–vorticity formulation of 3D incompressible Navier–Stokes.

spectralDNS ships both a velocity-form ("NS") and a vorticity-form ("VV")
solver on the reference transforms; this is the VV analog.  The state is the
spectral vorticity ω̂; velocity is recovered by Biot–Savart each RHS:

    û = i (k × ω̂) / |k|²            (exact since k·û = 0)
    ∂ω̂/∂t = i k × F(u×ω) − ν k² ω̂   (curl of the rotational form —
                                       the pressure term vanishes)

In exact arithmetic the VV trajectory is the curl of the velocity-form
trajectory (curl ∘ Leray-projection = curl), which the tests exploit as a
mutual oracle.  9 distributed transforms per RHS, same as the velocity form.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .navier_stokes import NavierStokes3D, SpectralSolver


class VorticityVelocity3D(SpectralSolver):
    """Vorticity-form pseudo-spectral solver over a slab/pencil R2C."""

    def __init__(self, FFT, nu: float, dt: float, dealias: Optional[str] = "2/3-rule",
                 integrator: str = "RK4"):
        self.nu = float(nu)
        self._init_solver(FFT, dt, dealias, integrator)

    # -- state construction -------------------------------------------------------

    def from_velocity(self, U_hat):
        """Spectral vorticity ω̂ = i k × û from a (3,)+spectral velocity."""
        def build():
            def f(U_hat, k0, k1, k2):
                K0 = k0[:, None, None]
                K1 = k1[None, :, None]
                K2v = k2[None, None, :]
                return jnp.stack([1j * (K1 * U_hat[2] - K2v * U_hat[1]),
                                  1j * (K2v * U_hat[0] - K0 * U_hat[2]),
                                  1j * (K0 * U_hat[1] - K1 * U_hat[0])])
            return f
        return self._plan("from_velocity", build)(U_hat,
                                                  *self._step_args())

    def velocity(self, W_hat):
        """Biot–Savart: û = i (k × ω̂)/|k|² (spectral)."""
        def build():
            def f(W_hat, k0, k1, k2):
                K0 = k0[:, None, None]
                K1 = k1[None, :, None]
                K2v = k2[None, None, :]
                ksq = K0 * K0 + K1 * K1 + K2v * K2v
                inv = 1.0 / jnp.where(ksq == 0, 1, ksq)
                return jnp.stack([1j * (K1 * W_hat[2] - K2v * W_hat[1]) * inv,
                                  1j * (K2v * W_hat[0] - K0 * W_hat[2]) * inv,
                                  1j * (K0 * W_hat[1] - K1 * W_hat[0]) * inv])
            return f
        return self._plan("velocity", build)(W_hat, *self._step_args())

    def taylor_green(self):
        ns = NavierStokes3D(self.FFT, nu=self.nu, dt=self.dt,
                            dealias=self.dealias)
        return self.from_velocity(ns.taylor_green())

    # -- dynamics ----------------------------------------------------------------

    def rhs(self, W_hat, k0, k1, k2):
        bwd, fwd = self._bwd_nl, self._fwd
        K0 = k0[:, None, None]
        K1 = k1[None, :, None]
        K2v = k2[None, None, :]
        ksq = K0 * K0 + K1 * K1 + K2v * K2v
        inv = 1.0 / jnp.where(ksq == 0, 1, ksq)
        # Biot–Savart velocity
        u0 = 1j * (K1 * W_hat[2] - K2v * W_hat[1]) * inv
        u1 = 1j * (K2v * W_hat[0] - K0 * W_hat[2]) * inv
        u2 = 1j * (K0 * W_hat[1] - K1 * W_hat[0]) * inv
        U = jnp.stack([bwd(u0), bwd(u1), bwd(u2)])
        W = jnp.stack([bwd(W_hat[i]) for i in range(3)])
        F0 = U[1] * W[2] - U[2] * W[1]
        F1 = U[2] * W[0] - U[0] * W[2]
        F2 = U[0] * W[1] - U[1] * W[0]
        F_hat = jnp.stack([fwd(F0), fwd(F1), fwd(F2)])
        # curl of the nonlinear term; pressure never appears
        return jnp.stack([1j * (K1 * F_hat[2] - K2v * F_hat[1]),
                          1j * (K2v * F_hat[0] - K0 * F_hat[2]),
                          1j * (K0 * F_hat[1] - K1 * F_hat[0])]) \
            - self.nu * ksq[None] * W_hat

    # step_fn/ab2_state/step/run: inherited from SpectralSolver

    # -- diagnostics ---------------------------------------------------------------

    def energy(self, W_hat) -> float:
        """Mean kinetic energy of the Biot–Savart velocity."""
        def build():
            def ke(W_hat, k0, k1, k2):
                K0 = k0[:, None, None]
                K1 = k1[None, :, None]
                K2v = k2[None, None, :]
                ksq = K0 * K0 + K1 * K1 + K2v * K2v
                inv = 1.0 / jnp.where(ksq == 0, 1, ksq)
                U_hat = jnp.stack(
                    [1j * (K1 * W_hat[2] - K2v * W_hat[1]) * inv,
                     1j * (K2v * W_hat[0] - K0 * W_hat[2]) * inv,
                     1j * (K0 * W_hat[1] - K1 * W_hat[0]) * inv])
                U = jnp.stack([self._bwd(U_hat[i]) for i in range(3)])
                return 0.5 * SpectralSolver.staged_mean(jnp.sum(U * U, axis=0))
            return ke
        return float(self._plan("energy", build)(W_hat, *self._step_args()))

    def enstrophy(self, W_hat) -> float:
        def build():
            def en(W_hat):
                W = jnp.stack([self._bwd(W_hat[i]) for i in range(3)])
                return 0.5 * SpectralSolver.staged_mean(jnp.sum(W * W, axis=0))
            return en
        return float(self._plan("enstrophy", build)(W_hat))
