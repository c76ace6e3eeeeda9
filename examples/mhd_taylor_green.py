"""MHD Taylor–Green demo: kinetic↔magnetic energy exchange.

Runs the incompressible MHD solver (models.MHD3D) on whatever devices are
visible; prints kinetic/magnetic energies and the solenoidality of both
fields over time.  Usage:

    python examples/mhd_taylor_green.py [N] [steps] [slab|pencil]
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

    from mpifft4py_tpu import slab, pencil
    from mpifft4py_tpu.models.mhd import MHD3D

    grid = np.array([N, N, N])
    L = np.array([2 * np.pi] * 3)
    if kind == "pencil" and len(jax.devices()) >= 4:
        FFT = pencil.R2C(grid, L, None, "single")
    else:
        FFT = slab.R2C(grid, L, None, "single")

    solver = MHD3D(FFT, nu=1e-3, eta=1e-3, dt=0.005, dealias="2/3-rule")
    UB = solver.taylor_green_mhd(b0=0.3)
    eu, eb = solver.energies(UB)
    print(f"t=0      E_kin={eu:.6f}  E_mag={eb:.6f}")

    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        UB = solver.step(UB)
        if i % max(1, steps // 5) == 0:
            eu, eb = solver.energies(UB)
            du, db = solver.divergences(UB)
            print(f"t={i * solver.dt:<8.3f} E_kin={eu:.6f}  E_mag={eb:.6f}  "
                  f"max|div u|={du:.2e}  max|div b|={db:.2e}")
    wall = time.perf_counter() - t0
    print(f"{steps} RK4 steps (~{steps * 72} distributed transforms) "
          f"in {wall:.2f}s = {wall / steps * 1e3:.1f} ms/step")


if __name__ == "__main__":
    main()
