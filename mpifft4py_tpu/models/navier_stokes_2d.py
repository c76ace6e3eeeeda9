"""2D incompressible Navier–Stokes in vorticity form — the line.R2C consumer.

Companion to the 3D solver: exercises the 2D transform family (line.R2C,
driver eval config 2's decomposition) in a real pseudo-spectral time loop.

Vorticity formulation:  ∂ω/∂t + u·∇ω = ν ∇²ω,  u = ∇⊥ψ,  ∇²ψ = −ω.
Spectral: ψ̂ = ω̂/|k|²;  û = (i k_y ψ̂, −i k_x ψ̂);  nonlinear term dealiased.

The state ω̂ is a standard complex (N0, Nfp) array carried through
``FFT.forward_fn``/``backward_fn``; it works for every P.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


class NavierStokes2D:
    def __init__(self, FFT, nu: float, dt: float, dealias: Optional[str] = "2/3-rule",
                 integrator: str = "RK4"):
        from .navier_stokes import INTEGRATORS
        self.FFT = FFT
        self.nu = float(nu)
        self.dt = float(dt)
        self.dealias = dealias
        if integrator not in INTEGRATORS:
            raise ValueError(f"integrator must be one of {INTEGRATORS}, "
                             f"got {integrator!r}")
        self.integrator = integrator
        K = FFT.get_scaled_local_wavenumbermesh()      # (2, N0, Nfp)
        K2 = jnp.sum(K * K, axis=0)
        self.K = K
        self.K2 = K2
        self.K2_inv = jnp.where(K2 == 0, 0.0, 1.0 / jnp.where(K2 == 0, 1.0, K2))
        self._fwd = FFT.forward_fn(dealias=dealias)
        self._bwd = FFT.backward_fn()
        self._bwd_nl = FFT.backward_fn(dealias) if dealias == "3/2-rule" else self._bwd
        self._step = None
        self._run = None
        self._ens = None

    # -- shared machinery --------------------------------------------------------

    def vortex_pair(self):
        """Two counter-rotating Gaussian vortices (classic test IC); spectral,
        dealiased ω̂."""
        X = self.FFT.get_local_mesh()

        def physical(X):
            x, y = X[0], X[1]
            L = 2 * np.pi
            return (jnp.exp(-((x - 0.4 * L) ** 2 + (y - 0.5 * L) ** 2) / 0.05)
                    - jnp.exp(-((x - 0.6 * L) ** 2 + (y - 0.5 * L) ** 2) / 0.05))

        return jax.jit(lambda X: self._fwd(physical(X)))(X)

    def rhs(self, w_hat, K, K2, K2i):
        psi_hat = w_hat * K2i
        u = self._bwd_nl(1j * K[1] * psi_hat)
        v = self._bwd_nl(-1j * K[0] * psi_hat)
        wx = self._bwd_nl(1j * K[0] * w_hat)
        wy = self._bwd_nl(1j * K[1] * w_hat)
        adv = self._fwd(u * wx + v * wy)
        return -adv - self.nu * K2 * w_hat

    def step_fn(self):
        # wavenumber arrays as explicit args, never closure constants
        # (see SpectralSolver.step_fn); integrator machinery shared with 3D
        from .navier_stokes import SpectralSolver

        def step(w_hat, K, K2, K2i):
            rhs1 = lambda V: self.rhs(V, K, K2, K2i)
            return SpectralSolver._advance(self, rhs1, w_hat)
        return step

    def _step_args(self):
        return (self.K, self.K2, self.K2_inv)

    def ab2_state(self, w_hat):
        """(w_hat, f_prev) carry for integrator='AB2' (first step = Euler seed)."""
        if self.integrator != "AB2":
            raise ValueError("ab2_state is only meaningful with integrator='AB2'")
        f = jax.jit(self.rhs)(w_hat, self.K, self.K2, self.K2_inv)
        return (w_hat, f)

    def step(self, w_hat):
        if self._step is None:
            self._step = jax.jit(self.step_fn())
        return self._step(w_hat, *self._step_args())

    def run(self, state, nsteps: int):
        """``nsteps`` steps as ONE jitted donated-carry scan (the
        benchmarking/production entry — mirrors SpectralSolver.run)."""
        if self._run is None:
            stepf = self.step_fn()

            def many(state, *args):
                return lax.scan(lambda c, _: (stepf(c, *args), None),
                                state, None, length=nsteps)[0]
            self._run = jax.jit(many, donate_argnums=0)
            self._run_len = nsteps
        assert self._run_len == nsteps, "run() recompiles on nsteps change"
        return self._run(state, *self._step_args())

    def enstrophy(self, w_hat) -> float:
        from .navier_stokes import SpectralSolver

        if self._ens is None:
            # cached plan: a fresh jax.jit(closure) per call would retrace
            # and recompile the inverse transform on every call
            def ens(W):
                w = self._bwd(W)
                return 0.5 * SpectralSolver.staged_mean(w * w)
            self._ens = jax.jit(ens)
        return float(self._ens(w_hat))
