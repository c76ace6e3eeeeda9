"""Pseudo-spectral incompressible 3D Navier–Stokes DNS — the flagship consumer.

This is the spectralDNS usage pattern the reference library was built to serve
(SURVEY.md §3.5): an RK4 timestep doing 3 inverse + 3 forward *dealiased*
distributed transforms per right-hand-side evaluation (~24+ 3D transforms per
timestep).  The reference keeps transforms and elementwise spectral algebra in
separate Python calls; here the whole RK4 substep is ONE jitted SPMD program —
XLA fuses the elementwise curl/cross/projection work into the transform
pipeline around the all-to-alls, something the FFTW+MPI stack could never do.

Formulation (rotational form, velocity in spectral space):

    dU_hat/dt = P[ F̂(U × ω) ] − ν k² U_hat,
    P(F̂)     = F̂ − K (K·F̂)/|K|²          (Leray projection)
    ω          = curl(u) = ifftn(i K × U_hat)

Works with any of the transform classes (slab/pencil) via their
``forward_fn``/``backward_fn`` composable pipelines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

# Carpenter & Kennedy (1994) five-stage fourth-order low-storage ("2N") RK.
# Memory: one state + one accumulator live across stages, where classical
# RK4 holds k1..k4 beside the state.
_LSRK54_A = (
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
)
_LSRK54_B = (
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
)

INTEGRATORS = ("RK4", "LSRK54", "Euler", "AB2")


class SpectralSolver:
    """Shared machinery for the spectral solver family (NS3D, VV, MHD,
    Boussinesq): integrator core, factored wavenumber state, cached jit
    plans, AB2 carry, and the scan-based ``run``.  Subclasses implement
    ``rhs(state, k0, k1, k2)`` and set physics parameters."""

    def _init_solver(self, FFT, dt, dealias, integrator):
        self.FFT = FFT
        self.dt = float(dt)
        self.dealias = dealias
        if integrator not in INTEGRATORS:
            raise ValueError(f"integrator must be one of {INTEGRATORS}, "
                             f"got {integrator!r}")
        self.integrator = integrator
        self._fwd = FFT.forward_fn(dealias=dealias)
        self._fwd_plain = FFT.forward_fn()
        self._bwd = FFT.backward_fn()
        # 3/2-rule: the nonlinear term is evaluated on the padsize×-refined
        # grid; 2/3-rule works on the N grid with the mask in the forward.
        self._bwd_nl = (FFT.backward_fn(dealias) if dealias == "3/2-rule"
                        else self._bwd)
        self._step = None
        self._solver_plans = {}

    def _plan(self, key, builder, **jit_kwargs):
        """Cached jit of ``builder()`` — diagnostics called per-step must not
        retrace and recompile.  ``jit_kwargs`` (e.g. donate_argnums) are
        applied on first build."""
        fn = self._solver_plans.get(key)
        if fn is None:
            fn = self._solver_plans[key] = jax.jit(builder(), **jit_kwargs)
        return fn

    # -- wavenumber machinery -------------------------------------------------
    # The step path uses only the FACTORED 1-D vectors; the full (3,)+spectral
    # meshes below are built lazily for diagnostics (at 512³ they are ~2 GB
    # of HBM the solver itself never needs).

    @property
    def K(self):
        if not hasattr(self, "_K_full"):
            self._K_full = self.FFT.get_scaled_local_wavenumbermesh()
        return self._K_full

    @property
    def K2(self):
        if not hasattr(self, "_K2_full"):
            self._K2_full = jnp.sum(self.K * self.K, axis=0)
        return self._K2_full

    @property
    def K_over_K2(self):
        if not hasattr(self, "_KK_full"):
            K2 = self.K2
            self._KK_full = self.K / jnp.where(K2 == 0, 1, K2)
        return self._KK_full

    @staticmethod
    def staged_mean(x):
        """Mean over ALL axes via sequential per-axis sums — each partial is
        short (≤ max(N) terms, ~sqrt(N)·eps error) where one flat f32 reduce
        over ~1e8 elements random-walks ~1e-4 relative (measured 4e-5 at a
        mere 32³ on XLA:CPU)."""
        n = float(np.prod(x.shape))
        s = x
        for _ in range(x.ndim):
            s = s.sum(axis=-1)
        return s / n

    def spectrum(self, state) -> np.ndarray:
        """Shell-binned kinetic-energy spectrum E(k) of the VELOCITY
        components.  Multi-field solvers (MHD/Boussinesq) bin components
        0..2 (û)."""
        from .diagnostics import energy_spectrum
        return np.asarray(energy_spectrum(self.FFT, state[:3]))

    def _factored_k(self):
        """1-D scaled wavenumbers matching global_complex_shape (replicated;
        GSPMD broadcasts them against the sharded spectral state)."""
        FFT = self.FFT
        N = [int(n) for n in FFT.N]
        nf = FFT.global_complex_shape()[2]
        ft = FFT.float  # f64 for native "double" — f32 k would cap 1/k² at ~1e-8
        s = (2 * np.pi / np.asarray(FFT.L)).astype(ft)
        k0 = np.fft.fftfreq(N[0], 1.0 / N[0]).astype(ft) * s[0]
        k1 = np.fft.fftfreq(N[1], 1.0 / N[1]).astype(ft) * s[1]
        # R2C Hermitian layout: k2 = 0..nf−1 (alignment-pad modes beyond
        # Nf are structural zeros; any nonzero k keeps K² safe there)
        k2 = np.arange(nf, dtype=ft) * s[2]
        return jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(k2)

    def _step_args(self):
        """(k0, k1, k2), built once: the wavenumber arguments of every step
        and diagnostic plan."""
        if not hasattr(self, "_k_args"):
            self._k_args = self._factored_k()
        return self._k_args

    # -- time integrators (pytree-generic) ------------------------------------

    def _advance(self, rhs1, U):
        """One step of ``self.integrator`` on pytree state ``U`` with pytree
        right-hand side ``rhs1``.  AB2 state is (U, f_prev) — built once by
        ``ab2_state``; its first application is the Euler-equivalent seed."""
        dt = self.dt
        tm = jax.tree.map
        it = self.integrator
        if it == "RK4":
            k1 = rhs1(U)
            k2 = rhs1(tm(lambda u, k: u + 0.5 * dt * k, U, k1))
            k3 = rhs1(tm(lambda u, k: u + 0.5 * dt * k, U, k2))
            k4 = rhs1(tm(lambda u, k: u + dt * k, U, k3))
            return tm(lambda u, a, b, c, d: u + (dt / 6.0) * (a + 2 * b + 2 * c + d),
                      U, k1, k2, k3, k4)
        if it == "LSRK54":
            # big states: a barrier between the two axpys lets the stage's
            # RHS output die before the new U allocates — without it the
            # peak slice co-holds r + dU + U_old + U_new (4 state-sized
            # pytrees; the binding allocation of the MHD-512³ LSRK54 ledger,
            # navier_stokes.py axpy fusions in the AOT dump).  Gated on
            # state size: for small states the fused single pass is faster.
            big = sum(l.size * l.dtype.itemsize
                      for l in jax.tree.leaves(U)) > 2e9
            dU = None
            for a, b in zip(_LSRK54_A, _LSRK54_B):
                r = rhs1(U)
                dU = r if dU is None else tm(lambda f, g: f + a * g, r, dU)
                if big:
                    dU = jax.lax.optimization_barrier(dU)
                U = tm(lambda u, g: u + dt * b * g, U, dU)
            return U
        if it == "Euler":
            return tm(lambda u, k: u + dt * k, U, rhs1(U))
        # AB2: U_{n+1} = U_n + dt (1.5 f_n − 0.5 f_{n−1})
        Un, fprev = U
        f = rhs1(Un)
        Unew = tm(lambda u, a, b: u + dt * (1.5 * a - 0.5 * b), Un, f, fprev)
        return (Unew, f)

    def step_fn(self):
        """The jittable step: (state, k0, k1, k2) -> state (for AB2 the state
        is the ``ab2_state`` tuple on both sides).

        The wavenumber arrays are explicit ARGUMENTS, not closures: closing
        over device-resident arrays makes jit inline them as constants, which
        costs a device->host fetch during lowering and a copy of each
        constant per executable.
        """
        def step(state, k0, k1, k2):
            return self._advance(lambda V: self.rhs(V, k0, k1, k2), state)
        return step

    def ab2_state(self, U):
        """Wrap a spectral state for integrator='AB2': (U, f_prev) with
        f_prev = f(U), so the first step reduces to Euler."""
        if self.integrator != "AB2":
            raise ValueError("ab2_state is only meaningful with integrator='AB2'")
        f = self._plan("ab2_rhs", lambda: self.rhs)(U, *self._step_args())
        return (U, f)

    def step(self, state):
        if self._step is None:
            self._step = jax.jit(self.step_fn())
        return self._step(state, *self._step_args())

    def _carry_state(self, c):
        """The physical state inside an integrator carry (AB2 carries
        (state, f_prev))."""
        return c[0] if self.integrator == "AB2" else c

    def _monitor_builder(self):
        """Jit-safe scalar monitor of the state: total Parseval energy of all
        components (spectral — no inverse transforms inside the scan)."""
        from .diagnostics import _hermitian_weights
        w = _hermitian_weights(self.FFT)
        ntot = float(np.prod([int(n) for n in self.FFT.N]))

        def mon(S):
            # dtype follows the state (f64 under native "double", else f32)
            mag = (jnp.real(S) ** 2 + jnp.imag(S) ** 2) * w
            return 0.5 * self.staged_mean(mag) * mag.size / (ntot * ntot)
        return mon

    def run(self, state, n_steps: int, monitor_every: Optional[int] = None):
        """n_steps under lax.scan (ONE compiled program, cached per shape).

        ``monitor_every=k`` additionally records the total Parseval energy of
        the state every k steps WITHOUT leaving the compiled program (no
        per-step dispatch or host readback): returns
        ``(final_state, trace)`` with ``trace.shape == (n_steps // k,)``
        (n_steps must be divisible by k).  Without it, returns the final
        state only.

        NOTE: the input ``state`` buffer is DONATED to the scan (the carry is
        updated in place), so the run never holds two copies of the state.
        Do not reuse ``state`` after calling run; keep the return value
        instead."""
        plans = getattr(self, "_run_plans", None)
        if plans is None:
            plans = self._run_plans = {}
        key = (n_steps, monitor_every)
        fn = plans.get(key)
        if fn is None:
            step = self.step_fn()
            if monitor_every is None:
                def body(u0, *args):
                    return jax.lax.scan(lambda c, _: (step(c, *args), None),
                                        u0, None, length=n_steps)[0]
            else:
                k = int(monitor_every)
                if n_steps % k:
                    raise ValueError(
                        f"n_steps={n_steps} not divisible by "
                        f"monitor_every={k}")
                mon = self._monitor_builder()

                def body(u0, *args):
                    def chunk(c, _):
                        c = jax.lax.scan(
                            lambda cc, _: (step(cc, *args), None),
                            c, None, length=k)[0]
                        return c, mon(self._carry_state(c))
                    return jax.lax.scan(chunk, u0, None,
                                        length=n_steps // k)
            fn = plans[key] = jax.jit(body, donate_argnums=0)
        return fn(state, *self._step_args())


class NavierStokes3D(SpectralSolver):
    """RK4 pseudo-spectral solver over a slab or pencil transform object.

    Args:
      FFT: a ``slab.R2C`` or ``pencil.R2C`` instance (the decomposition).
      nu: kinematic viscosity.
      dt: timestep.
      dealias: None | "2/3-rule" | "3/2-rule" — applied to the nonlinear term's
        forward transforms (reference DNS loop convention).
      integrator: one of INTEGRATORS — "RK4" (classical, default),
        "LSRK54" (Carpenter–Kennedy 2N-storage RK4(5): ~half the live
        state of RK4), "Euler", "AB2"
        (Adams–Bashforth 2; state is (U, f_prev) — see ``ab2_state``).
        The same set spectralDNS exposed on top of the reference transforms.
    """

    def __init__(self, FFT, nu: float, dt: float, dealias: Optional[str] = "2/3-rule",
                 integrator: str = "RK4",
                 forcing_band: Optional[tuple] = None, forcing_rate: float = 0.0):
        """``forcing_band=(k_lo, k_hi)`` with ``forcing_rate=ε`` adds the
        constant-energy-injection low-wavenumber forcing of forced isotropic
        turbulence (the spectralDNS sustained-turbulence configuration):
        f̂ = ε·û/(2·E_band) on modes k_lo ≤ |k| < k_hi — injects energy at
        exactly ε per unit time regardless of the band's current energy."""
        self.nu = float(nu)
        self.forcing_band = (None if forcing_band is None
                             else (float(forcing_band[0]), float(forcing_band[1])))
        self.forcing_rate = float(forcing_rate)
        self._init_solver(FFT, dt, dealias, integrator)

    # -- initial conditions ---------------------------------------------------

    def taylor_green(self):
        """Taylor–Green vortex initial condition in spectral space:
        (3,) + global_complex_shape()."""
        X = self.FFT.get_local_mesh()
        def init(X):
            u = jnp.stack([
                jnp.sin(X[0]) * jnp.cos(X[1]) * jnp.cos(X[2]),
                -jnp.cos(X[0]) * jnp.sin(X[1]) * jnp.cos(X[2]),
                jnp.zeros_like(X[0]),
            ])
            return jnp.stack([self._fwd_plain(u[i]) for i in range(3)])
        return jax.jit(init)(X)

    # -- dynamics ----------------------------------------------------------------

    def rhs(self, U_hat, k0, k1, k2):
        """dU_hat/dt.  Pure function of the sharded state; jit/scan-safe.

        Wavenumbers arrive FACTORED as 1-D arrays (k0, k1, k2) — the
        (3,)+spectral K / K² / K/K² fields are never materialised; GSPMD
        broadcasts the replicated vectors against the sharded spectral state
        in-register.  Transforms run per component; whether the batched
        ``*_fields_fn`` API (one collective per stack) is faster on the GPU
        is not measured.
        """
        bwd, fwd = self._bwd_nl, self._fwd
        K0 = k0[:, None, None]
        K1 = k1[None, :, None]
        K2v = k2[None, None, :]
        U = jnp.stack([bwd(U_hat[i]) for i in range(3)])
        # vorticity: ω = ifftn(i K × U_hat)
        cu0 = 1j * (K1 * U_hat[2] - K2v * U_hat[1])
        cu1 = 1j * (K2v * U_hat[0] - K0 * U_hat[2])
        cu2 = 1j * (K0 * U_hat[1] - K1 * U_hat[0])
        W = jnp.stack([bwd(cu0), bwd(cu1), bwd(cu2)])
        # nonlinear term F = U × ω, transformed with dealiasing
        F0 = U[1] * W[2] - U[2] * W[1]
        F1 = U[2] * W[0] - U[0] * W[2]
        F2 = U[0] * W[1] - U[1] * W[0]
        F_hat = jnp.stack([fwd(F0), fwd(F1), fwd(F2)])
        # Leray projection + viscous term
        ksq = K0 * K0 + K1 * K1 + K2v * K2v
        div = (K0 * F_hat[0] + K1 * F_hat[1] + K2v * F_hat[2]) \
            / jnp.where(ksq == 0, 1, ksq)
        F_hat = F_hat - jnp.stack([K0 * div, K1 * div, K2v * div])
        dU = F_hat - self.nu * ksq[None] * U_hat
        if self.forcing_band is not None and self.forcing_rate > 0:
            # constant-energy-injection band forcing: f̂ = α·û on
            # k_lo ≤ |k| < k_hi with α = ε/(2 E_band) ⇒ dE/dt |_f = ε exactly
            klo, khi = self.forcing_band
            band = (ksq >= klo * klo) & (ksq < khi * khi)
            # Hermitian half-spectrum weights: k2 = 0 AND the self-conjugate
            # z-Nyquist plane carry weight 1, interior columns weight 2
            kny = float(np.pi * int(self.FFT.N[2]) / float(self.FFT.L[2]))
            w = jnp.where((K2v == 0) | (K2v >= kny * (1.0 - 1e-6)), 1.0, 2.0)
            ntot = float(np.prod([int(n) for n in self.FFT.N]))
            Eb = jnp.sum(jnp.where(band, w * jnp.abs(U_hat) ** 2, 0.0)) \
                / (2.0 * ntot * ntot)
            alpha = jnp.where(Eb > 0, self.forcing_rate / (2.0 * Eb), 0.0)
            dU = dU + (alpha * band) * U_hat
        return dU

    # -- diagnostics --------------------------------------------------------------

    def energy(self, U_hat) -> float:
        """Mean kinetic energy 0.5 <|u|²> (physical space)."""

        def build():
            def ke(U_hat):
                U = jnp.stack([self._bwd(U_hat[i]) for i in range(3)])
                return 0.5 * self.staged_mean(jnp.sum(U * U, axis=0))
            return ke
        return float(self._plan("energy", build)(U_hat))

    def rhs_with_state(self, U_hat):
        """Convenience: rhs using the stored wavenumber vectors (eager use)."""
        return self.rhs(U_hat, *self._step_args())
