"""Production checkpoint/restart workflow.

Demonstrates the three resume mechanisms:
  1. mid-run checkpoint of the spectral state (utils.io.save_state),
  2. bit-identical continuation from the restored state,
  3. resolution-change restart: regrid the saved spectrum to a finer grid
     (utils.spectral.regrid) and continue there.

Usage:  python examples/checkpoint_restart.py [N] [steps]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    from mpifft4py_tpu import slab
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    from mpifft4py_tpu.utils import io
    from mpifft4py_tpu.utils.spectral import regrid

    grid = np.array([N, N, N])
    L = np.array([2 * np.pi] * 3)
    FFT = slab.R2C(grid, L, None, "single")
    kw = dict(nu=1e-3, dt=0.005, dealias="2/3-rule")
    solver = NavierStokes3D(FFT, **kw)

    U = solver.taylor_green()
    for _ in range(steps):
        U = solver.step(U)
    e_mid = solver.energy(U)
    print(f"t={steps * solver.dt:.3f}  E={e_mid:.8f}  (checkpointing here)")

    path = os.path.join(tempfile.gettempdir(), f"dns_{N}.npz")
    io.save_state(path, FFT, U, step=steps, t=steps * solver.dt)

    # --- restart: fresh transform + solver, restore, continue -------------
    FFT2 = slab.R2C(grid, L, None, "single")
    solver2 = NavierStokes3D(FFT2, **kw)
    U2, meta = io.load_state(path, FFT2)
    print(f"restored step={int(meta['step'])}  E={solver2.energy(U2):.8f} "
          f"(must equal the checkpoint energy)")
    ref = solver.step(U)
    got = solver2.step(U2)
    e_ref, e_got = solver.energy(ref), solver2.energy(got)
    print(f"one more step: original E={e_ref:.10f}  restarted E={e_got:.10f} "
          f"(diff {abs(e_ref - e_got):.2e})")

    # --- resolution-change restart: continue on a 1.5x finer grid ---------
    M = np.array([3 * N // 2] * 3)
    host = FFT2.gather(U2)
    fine = regrid(host, N_new=M, N_old=grid)   # handles the component stack
    FFT3 = slab.R2C(M, L, None, "single")
    solver3 = NavierStokes3D(FFT3, **kw)
    U3 = FFT3.shard_complex(fine.astype(np.complex64))
    print(f"regrid {N}^3 -> {int(M[0])}^3:  E={solver3.energy(U3):.8f} "
          f"(continuous across the regrid to the f32 diagnostic's ~1e-5; "
          f"spectrally it is exact — tests/test_io.py)")
    U3 = solver3.step(U3)
    print(f"continued on the fine grid: E={solver3.energy(U3):.8f}")
    os.remove(path)


if __name__ == "__main__":
    main()
