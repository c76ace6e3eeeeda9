"""Stratified Boussinesq demo: internal-wave energy exchange.

Runs the buoyancy-coupled solver (models.Boussinesq3D) on whatever devices
are visible; a Taylor–Green velocity stirs a θ = θ0·sin(z) stratification and
kinetic energy sloshes into scalar variance and back (internal waves) while
viscosity/diffusivity drain the total.  Usage:

    python examples/stratified_boussinesq.py [N] [steps] [slab|pencil] [Ri]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import jax

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    kind = sys.argv[3] if len(sys.argv) > 3 else "slab"
    Ri = float(sys.argv[4]) if len(sys.argv) > 4 else 1.0

    from mpifft4py_tpu import slab, pencil
    from mpifft4py_tpu.models.boussinesq import Boussinesq3D

    grid = np.array([N, N, N])
    L = np.array([2 * np.pi] * 3)
    if kind == "pencil" and len(jax.devices()) >= 4:
        FFT = pencil.R2C(grid, L, None, "single")
    else:
        FFT = slab.R2C(grid, L, None, "single")

    solver = Boussinesq3D(FFT, nu=1e-3, kappa=1e-3, Ri=Ri, dt=0.005,
                          dealias="2/3-rule")
    print(f"Ri = {Ri}")
    S = solver.taylor_green_stratified(theta0=0.2)
    eu, et = solver.energies(S)
    print(f"t=0      E_kin={eu:.6f}  E_theta={et:.6f}  total={eu + Ri * et:.6f}")

    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        S = solver.step(S)
        if i % max(1, steps // 5) == 0:
            eu, et = solver.energies(S)
            # E_kin + Ri·E_theta is the wave-exchange invariant of the
            # inviscid linearised system — it should decay slowly (ν, κ)
            # while the two parts oscillate against each other
            print(f"t={i * solver.dt:<8.3f} E_kin={eu:.6f}  E_theta={et:.6f}  "
                  f"E_kin+Ri·E_theta={eu + Ri * et:.6f}")
    solver.energies(S)   # scalar fetch: waits for the device
    wall = time.perf_counter() - t0
    print(f"{steps} RK4 steps (52 distributed transforms each) "
          f"in {wall:.2f}s = {wall / steps * 1e3:.1f} ms/step "
          f"(eager-loop upper bound; use solver.run() for production)")


if __name__ == "__main__":
    main()
