"""Device-memory ledger via AOT compile — no execution required.

``jit(...).lower(...).compile().memory_analysis()`` returns XLA's buffer
assignment for the backend it runs on, so "does this solver step fit the
card?" is answerable exactly, integrator by integrator, without running the
step or risking an out-of-memory failure.

Usage:
    python benchmarks/memory_ledger.py <model: ns|vv|mhd|bq> <N> <integrator> [n_steps=3]

Prints one JSON line: argument/output/temp/alias sizes and the peak estimate
(arguments + temps; outputs are donation-aliased into the arguments).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    model = sys.argv[1] if len(sys.argv) > 1 else "mhd"
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    integ = sys.argv[3] if len(sys.argv) > 3 else "LSRK54"
    n_steps = int(sys.argv[4]) if len(sys.argv) > 4 else 3

    from mpifft4py_tpu.utils.cache import enable_wisdom_cache
    enable_wisdom_cache()
    import jax

    from mpifft4py_tpu import slab
    from mpifft4py_tpu.models.boussinesq import Boussinesq3D
    from mpifft4py_tpu.models.mhd import MHD3D
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    from mpifft4py_tpu.models.vv import VorticityVelocity3D

    FFT = slab.R2C(np.array([N] * 3), np.array([2 * np.pi] * 3), None,
                   "single")
    make = {
        "ns": lambda: (NavierStokes3D(FFT, nu=1e-3, dt=1e-3,
                                      dealias="2/3-rule",
                                      integrator=integ), 3),
        "vv": lambda: (VorticityVelocity3D(FFT, nu=1e-3, dt=1e-3,
                                           dealias="2/3-rule",
                                           integrator=integ), 3),
        "mhd": lambda: (MHD3D(FFT, nu=1e-3, eta=1e-3, dt=1e-3,
                              dealias="2/3-rule", integrator=integ), 6),
        "bq": lambda: (Boussinesq3D(FFT, nu=1e-3, kappa=1e-3, dt=1e-3,
                                    Ri=0.5, dealias="2/3-rule",
                                    integrator=integ), 4),
    }
    solver, ncomp = make[model]()

    # the exact run() program: an n-step scan of the step, state donated
    step = solver.step_fn()

    def body(u0, *args):
        return jax.lax.scan(lambda c, _: (step(c, *args), None),
                            u0, None, length=n_steps)[0]

    sds = jax.ShapeDtypeStruct
    state = sds((ncomp,) + FFT.global_complex_shape(), FFT.complex)
    kargs = tuple(sds(k.shape, k.dtype) for k in solver._step_args())
    if integ == "AB2":  # carry is (state, f_prev)
        state = (state, state)

    out = {"model": model, "N": N, "integrator": integ, "n_steps": n_steps}
    gib = 1024.0 ** 3
    try:
        c = jax.jit(body, donate_argnums=0).lower(state, *kargs).compile()
    except Exception as e:  # XLA OOM: parse "Used X of Y" from the report
        import re
        msg = str(e)
        if "--dump" in sys.argv:      # full largest-allocations report
            sys.stderr.write(msg + "\n")
        m = re.search(r"Used ([\d.]+)G of ([\d.]+)G", msg)
        f = re.search(r"([\d.]+)% fragmentation \(([\d.]+)G", msg)
        out.update({"ok": False,
                    "used_gib": float(m.group(1)) if m else None,
                    "capacity_gib": float(m.group(2)) if m else None,
                    "frag_gib": float(f.group(2)) if f else None})
        print(json.dumps(out), flush=True)
        if m is None:
            raise
        return
    ma = c.memory_analysis()
    # Peak = arguments + temps + any NON-aliased output residue.  Outputs are
    # normally donation-aliased into the arguments (alias == output); if XLA
    # declines donation (dtype/layout mismatch, future integrator carries)
    # the un-aliased part is real extra residency — count it, don't hide it.
    unaliased = max(0, ma.output_size_in_bytes - ma.alias_size_in_bytes)
    out.update({
        "ok": True,
        "args_gib": round(ma.argument_size_in_bytes / gib, 3),
        "output_gib": round(ma.output_size_in_bytes / gib, 3),
        "alias_gib": round(ma.alias_size_in_bytes / gib, 3),
        "temp_gib": round(ma.temp_size_in_bytes / gib, 3),
        "unaliased_out_gib": round(unaliased / gib, 3),
        "peak_gib": round((ma.argument_size_in_bytes
                           + ma.temp_size_in_bytes + unaliased) / gib, 3),
    })
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
