"""Pseudo-spectral incompressible 3D magnetohydrodynamics — second consumer.

spectralDNS (the reference library's consumer) ships an MHD solver on the same
transform engine; this is its analog over slab/pencil ``R2C``.
Standard (u, b) rotational form in Alfvén units:

    ∂û/∂t = P[ F(u×ω + j×b) ] − ν k² û          ω = ∇×u,  j = ∇×b
    ∂b̂/∂t = i k × F(u×b) − η k² b̂

The induction term is curled AFTER the forward transform, so ∇·b = 0 is
preserved exactly (machine precision) regardless of aliasing; the Lorentz
force rides the same Leray projection as the advective term.  18 distributed
transforms per RHS (12 inverse + 6 forward, dealiased) — 1.5× the
Navier–Stokes count, same choreography.

State layout: one stacked spectral array (6,) + global_complex_shape() —
components 0..2 = û, 3..5 = b̂ — so every integrator in
``navier_stokes.INTEGRATORS`` applies unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .navier_stokes import SpectralSolver


class MHD3D(SpectralSolver):
    """Incompressible MHD over a slab/pencil R2C transform.

    Args:
      FFT: slab.R2C or pencil.R2C.
      nu: kinematic viscosity; eta: magnetic diffusivity.
      dealias: applied to the nonlinear forward transforms.
      integrator: any of navier_stokes.INTEGRATORS.
    """

    def __init__(self, FFT, nu: float, eta: float, dt: float,
                 dealias: Optional[str] = "2/3-rule", integrator: str = "RK4"):
        self.nu = float(nu)
        self.eta = float(eta)
        self._init_solver(FFT, dt, dealias, integrator)

    # -- initial conditions -----------------------------------------------------

    def taylor_green_mhd(self, b0: float = 0.1):
        """TG velocity + perpendicular seed field (classic MHD test IC):
        returns the stacked (6,)+global_complex_shape() spectral state."""
        X = self.FFT.get_local_mesh()

        def init(X):
            u = jnp.stack([
                jnp.sin(X[0]) * jnp.cos(X[1]) * jnp.cos(X[2]),
                -jnp.cos(X[0]) * jnp.sin(X[1]) * jnp.cos(X[2]),
                jnp.zeros_like(X[0]),
            ])
            b = b0 * jnp.stack([
                jnp.cos(X[0]) * jnp.sin(X[1]) * jnp.sin(X[2]),
                jnp.sin(X[0]) * jnp.cos(X[1]) * jnp.sin(X[2]),
                -2.0 * jnp.sin(X[0]) * jnp.sin(X[1]) * jnp.cos(X[2]),
            ])
            return jnp.stack([self._fwd_plain(u[i]) for i in range(3)]
                             + [self._fwd_plain(b[i]) for i in range(3)])
        return jax.jit(init)(X)

    # -- dynamics ---------------------------------------------------------------

    def rhs(self, UB_hat, k0, k1, k2):
        """d(û, b̂)/dt on the stacked (6,)+spectral state (factored 1-D k)."""
        bwd, fwd = self._bwd_nl, self._fwd
        K0 = k0[:, None, None]
        K1 = k1[None, :, None]
        K2v = k2[None, None, :]

        def curl_hat(V):  # i K × V̂ (spectral)
            return jnp.stack([1j * (K1 * V[2] - K2v * V[1]),
                              1j * (K2v * V[0] - K0 * V[2]),
                              1j * (K0 * V[1] - K1 * V[0])])

        def cross(A, B):  # physical-space cross product
            return jnp.stack([A[1] * B[2] - A[2] * B[1],
                              A[2] * B[0] - A[0] * B[2],
                              A[0] * B[1] - A[1] * B[0]])

        U_hat, B_hat = UB_hat[:3], UB_hat[3:]
        U = jnp.stack([bwd(U_hat[i]) for i in range(3)])
        B = jnp.stack([bwd(B_hat[i]) for i in range(3)])
        W = jnp.stack([bwd(c) for c in curl_hat(U_hat)])   # vorticity
        J = jnp.stack([bwd(c) for c in curl_hat(B_hat)])   # current density
        Fu = cross(U, W) + cross(J, B)        # u×ω + j×b
        Fb = cross(U, B)                      # u×b (electromotive force)
        Fu_hat = jnp.stack([fwd(Fu[i]) for i in range(3)])
        Fb_hat = jnp.stack([fwd(Fb[i]) for i in range(3)])
        # momentum: Leray projection + viscosity
        ksq = K0 * K0 + K1 * K1 + K2v * K2v
        div = (K0 * Fu_hat[0] + K1 * Fu_hat[1] + K2v * Fu_hat[2]) \
            / jnp.where(ksq == 0, 1, ksq)
        dU = Fu_hat - jnp.stack([K0 * div, K1 * div, K2v * div]) \
            - self.nu * ksq[None] * U_hat
        # induction: i k × F(u×b) is divergence-free by construction
        dB = curl_hat(Fb_hat) - self.eta * ksq[None] * B_hat
        return jnp.concatenate([dU, dB])

    # step_fn/ab2_state/step/run: inherited from SpectralSolver

    # -- diagnostics --------------------------------------------------------------

    def energies(self, UB_hat):
        """(kinetic, magnetic) mean energies 0.5<|u|²>, 0.5<|b|²>."""

        def build():
            def ke(UB_hat):
                U = jnp.stack([self._bwd(UB_hat[i]) for i in range(3)])
                B = jnp.stack([self._bwd(UB_hat[3 + i]) for i in range(3)])
                sm = SpectralSolver.staged_mean
                return (0.5 * sm(jnp.sum(U * U, axis=0)),
                        0.5 * sm(jnp.sum(B * B, axis=0)))
            return ke
        eu, eb = self._plan("energies", build)(UB_hat)
        return float(eu), float(eb)

    def divergences(self, UB_hat):
        """(max |∇·u|, max |∇·b|) in spectral space — both must be ~0."""
        def build():
            def dv(UB_hat, k0, k1, k2):
                K0 = k0[:, None, None]
                K1 = k1[None, :, None]
                K2v = k2[None, None, :]

                def div3(V):
                    return K0 * V[0] + K1 * V[1] + K2v * V[2]
                return (jnp.abs(div3(UB_hat[:3])).max(),
                        jnp.abs(div3(UB_hat[3:])).max())
            return dv
        a, b = self._plan("divergences", build)(UB_hat, *self._step_args())
        return float(a), float(b)
