"""Forced isotropic turbulence: sustained cascade with energy spectra.

Low-wavenumber constant-energy-injection forcing keeps the flow statistically
steady while viscosity dissipates at the small scales — the classic
spectralDNS sustained-turbulence configuration.  Prints total energy and the
shell-binned spectrum's low/high-band split over time.

    python examples/forced_turbulence.py [N] [steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 50

    from mpifft4py_tpu import slab
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    from mpifft4py_tpu.models.diagnostics import energy_spectrum

    grid = np.array([N, N, N])
    L = np.array([2 * np.pi] * 3)
    FFT = slab.R2C(grid, L, None, "single")
    solver = NavierStokes3D(FFT, nu=0.005, dt=0.005, dealias="2/3-rule",
                            forcing_band=(0.5, 2.5), forcing_rate=0.1)
    U = solver.taylor_green()
    print(f"t=0      E={solver.energy(U):.6f}")

    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        U = solver.step(U)
        if i % max(1, steps // 5) == 0:
            e = solver.energy(U)
            Ek = np.asarray(energy_spectrum(FFT, U))
            lo = float(Ek[:3].sum())
            hi = float(Ek[3:].sum())
            print(f"t={i * solver.dt:<8.3f} E={e:.6f}  "
                  f"E(k<3)={lo:.4f}  E(k>=3)={hi:.4f}")
    wall = time.perf_counter() - t0
    print(f"{steps} steps in {wall:.2f}s = {wall / steps * 1e3:.1f} ms/step "
          f"(forcing holds the energy; the cascade fills k>=3)")


if __name__ == "__main__":
    main()
