"""Accuracy audit in the driver's units: MAX RELATIVE round-trip/forward error.

Measures against the BASELINE max-*relative* targets (<1e-6 fp32, <1e-12
fp64), on whatever device JAX finds:

  * forward error:    |fftn(u) - numpy.rfftn(u)|_max / |numpy|_max
  * round-trip error: |ifftn(fftn(u)) - u|_max / |u|_max

for plain, 2/3-rule (masked oracle), and 3/2-rule (round trip through the
padded grid) at 64^3..512^3 fp32, and 64^3 "double" both native and
doubleword.  Writes a JSON table with --out; tests/test_accuracy_gpu.py
asserts the targets on the GPU.

Usage: python benchmarks/accuracy_audit.py [--big] [--dd256] [--out FILE]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def audit_fp32(N, rows):
    from mpifft4py_tpu.slab import R2C
    TAU = 2 * np.pi
    rng = np.random.default_rng(0)
    FFT = R2C(np.array([N] * 3), np.array([TAU] * 3), 1, "single")
    u = rng.standard_normal((N, N, N)).astype(np.float32)
    ref = np.fft.rfftn(u.astype(np.float64))
    rmax = np.abs(ref).max()

    fu = FFT.gather(FFT.fftn(u))
    fwd = np.abs(fu - ref).max() / rmax
    ub = FFT.gather(FFT.ifftn(FFT.fftn(u)))
    rt = np.abs(ub - u).max() / np.abs(u).max()
    rows.append({"case": f"slab_{N}c_fp32_plain", "fwd_rel": float(fwd),
                 "roundtrip_rel": float(rt)})

    # 2/3-rule: forward vs masked oracle
    fu23 = FFT.gather(FFT.fftn(u, dealias="2/3-rule"))
    filt = np.asarray(FFT.get_dealias_filter()).astype(bool)
    fwd23 = np.abs(fu23 - np.where(filt, ref, 0)).max() / rmax
    rows.append({"case": f"slab_{N}c_fp32_23rule", "fwd_rel": float(fwd23)})

    # 3/2-rule: spectrum -> padded physical -> spectrum must be identity
    fu0 = FFT.fftn(u)
    up = FFT.ifftn(fu0, dealias="3/2-rule")
    fu2 = FFT.gather(FFT.fftn(up, dealias="3/2-rule"))
    rt32 = np.abs(fu2 - FFT.gather(fu0)).max() / rmax
    rows.append({"case": f"slab_{N}c_fp32_32rule", "roundtrip_rel": float(rt32)})


def audit_native(N, rows):
    from mpifft4py_tpu.slab import R2C
    rng = np.random.default_rng(1)
    FFT = R2C(np.array([N] * 3), np.array([2 * np.pi] * 3), 1, "double",
              fp64_mode="native")
    u = rng.standard_normal((N, N, N))
    ref = np.fft.rfftn(u)
    fu = FFT.fftn(u)
    fwd = np.abs(FFT.gather(fu) - ref).max() / np.abs(ref).max()
    rt = np.abs(FFT.gather(FFT.ifftn(fu)) - u).max() / np.abs(u).max()
    rows.append({"case": f"slab_{N}c_fp64_native", "fwd_rel": float(fwd),
                 "roundtrip_rel": float(rt)})


def audit_dd(N, rows):
    from mpifft4py_tpu.slab import R2C
    TAU = 2 * np.pi
    rng = np.random.default_rng(1)
    FFT = R2C(np.array([N] * 3), np.array([TAU] * 3), 1, "double",
              fp64_mode="doubleword")
    u = rng.standard_normal((N, N, N))
    ref = np.fft.rfftn(u)
    fu = FFT.fftn(u)
    fwd = np.abs(FFT.gather_dd(fu) - ref).max() / np.abs(ref).max()
    ub = FFT.gather_dd(FFT.ifftn(fu))
    rt = np.abs(ub - u).max() / np.abs(u).max()
    rows.append({"case": f"slab_{N}c_doubleword_plain", "fwd_rel": float(fwd),
                 "roundtrip_rel": float(rt)})
    up = FFT.ifftn(fu, dealias="3/2-rule")
    fu2 = FFT.gather_dd(FFT.fftn(up, dealias="3/2-rule"))
    rt32 = np.abs(fu2 - FFT.gather_dd(fu)).max() / np.abs(ref).max()
    rows.append({"case": f"slab_{N}c_doubleword_32rule",
                 "roundtrip_rel": float(rt32)})


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    rows = []
    sizes = [64] if jax.default_backend() == "cpu" else [64, 256]
    if "--big" in sys.argv:
        sizes += [384, 512]   # 384 = 3*2^7: the mixed-radix tier
    for N in sizes:
        audit_fp32(N, rows)
        print(json.dumps(rows[-3:]), flush=True)
    audit_native(64, rows)
    audit_dd(64, rows)
    if "--dd256" in sys.argv:
        # does <1e-12 hold at a size where twiddle error accumulates?
        audit_dd(256, rows)
        print(json.dumps(rows[-2:]), flush=True)
    print(json.dumps({"accuracy_audit": rows,
                      "backend": jax.default_backend()}))
    if "--out" in sys.argv:
        path = sys.argv[sys.argv.index("--out") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"backend": jax.default_backend(), "rows": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
