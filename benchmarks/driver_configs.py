"""BASELINE.md eval-config sweep (configs 1-5, scaled to available devices).

On the accelerator:  python benchmarks/driver_configs.py
On the CPU mesh:     python benchmarks/driver_configs.py --cpu8   (64³ grids)
CI smoke:            python benchmarks/driver_configs.py --cpu8 --smoke

Prints one JSON line per config: time, accuracy, transpose GB/s per device;
with ``--out FILE`` also writes the summary JSON there.  Times from the CPU
mesh measure XLA:CPU, not a device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    if "--cpu8" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    smoke = "--smoke" in sys.argv
    # BASELINE's 256³ on the accelerator; 64³ keeps the CPU mesh quick
    n3 = 32 if smoke else (64 if "--cpu8" in sys.argv else 256)
    import jax
    jax.config.update("jax_enable_x64", True)   # config 1: native "double"
    from mpifft4py_tpu import slab, line, pencil
    from mpifft4py_tpu.utils.profiling import measure, transpose_stats

    ndev = len(jax.devices())
    TAU = 2 * np.pi
    rng = np.random.default_rng(0)
    results = []

    def report(name, FFT, t_rt, err):
        st = transpose_stats(FFT, t_rt)
        row = {"config": name, "roundtrip_ms": round(t_rt * 1e3, 3),
               "max_rel_err": float(err), "devices": FFT.P,
               "transpose_GBps_chip": round(st.gb_per_s_per_chip, 2)}
        results.append(row)
        print(json.dumps(row), flush=True)

    # 1. slab R2C 64^3 "double", round-trip vs numpy.fft.rfftn
    N = 64
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), None, "double")
    u = rng.standard_normal((N, N, N))
    if FFT.policy.path == "doubleword":
        fu = FFT.fftn(u)
        out = FFT.gather_dd(fu)
        ub = FFT.gather_dd(FFT.ifftn(fu))
    else:
        fu = FFT.fftn(u)
        out = FFT.gather(fu)
        ub = np.asarray(FFT.ifftn(fu))
    ref = np.fft.rfftn(u)
    err = max(np.abs(out - ref).max() / np.abs(ref).max(),
              np.abs(ub - u).max() / np.abs(u).max())
    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    t = measure(lambda v: bwd(fwd(v)),
                FFT.shard_real_dd(u) if FFT.policy.path == "doubleword"
                else FFT.shard_real(u))
    report("1_slab_r2c_64cubed_double", FFT, t, err)

    # 2. line R2C 512^2
    N = 128 if smoke else 512
    FFT = line.R2C(np.array([N, N]), np.array([TAU, TAU]), None, "single")
    u32 = rng.standard_normal((N, N)).astype(np.float32)
    fu = FFT.fft2(u32)
    out = FFT.gather(fu)[:, :FFT.Nf]
    ref = np.fft.rfft2(u32.astype(np.float64))
    err = np.abs(out - ref).max() / np.abs(ref).max()
    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    t = measure(lambda v: bwd(fwd(v)), FFT.shard_real(u32))
    report("2_line_r2c_512sq", FFT, t, err)

    # 3. slab R2C 256^3 with dealiased (2/3-rule and 3/2-rule) transforms
    N = n3
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), None, "single")
    u32 = rng.standard_normal((N, N, N)).astype(np.float32)
    fwd23 = FFT.forward_fn("2/3-rule")
    bwd = FFT.backward_fn()
    t = measure(lambda v: bwd(fwd23(v)), FFT.shard_real(u32))
    # accuracy via plain roundtrip (relative error)
    ub = np.asarray(FFT.ifftn(FFT.fftn(u32)))
    err = np.abs(ub - u32).max() / np.abs(u32).max()
    report("3_slab_r2c_dealiased", FFT, t, err)
    # 3b. padded variant: fftn(3/2) ∘ ifftn(3/2) on the spectrum
    fwd32, bwd32 = FFT.forward_fn("3/2-rule"), FFT.backward_fn("3/2-rule")
    fu0 = FFT.fftn(u32)
    t32 = measure(lambda f: fwd32(bwd32(f)), fu0)
    report("3b_slab_r2c_padded32", FFT, t32, err)

    # 4s. pencil on ONE device (P1=P2=1: both grouped all-to-alls
    # degenerate) — config 4's decomposition class where only one exists
    if ndev < 4:
        N = n3
        FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 1, "single")
        u32 = rng.standard_normal((N, N, N)).astype(np.float32)
        out = FFT.gather(FFT.fftn(u32))[..., :FFT.Nf]
        ref = np.fft.rfftn(u32.astype(np.float64))
        err = np.abs(out - ref).max() / np.abs(ref).max()
        fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
        t = measure(lambda v: bwd(fwd(v)), FFT.shard_real(u32))
        report("4s_pencil_r2c_single_chip", FFT, t, err)

    # 4. pencil R2C on a 2D mesh (P1xP2)
    if ndev >= 4:
        N = n3
        FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), None, "single")
        u32 = rng.standard_normal((N, N, N)).astype(np.float32)
        fu = FFT.fftn(u32)
        out = FFT.gather(fu)[..., :FFT.Nf]
        ref = np.fft.rfftn(u32.astype(np.float64))
        err = np.abs(out - ref).max() / np.abs(ref).max()
        fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
        t = measure(lambda v: bwd(fwd(v)), FFT.shard_real(u32))
        report("4_pencil_r2c_2dmesh", FFT, t, err)

        # 5. DNS-style dealiased transform loop, overlapped transpose/FFT:
        # 3/2-rule padded inverse+forward with pipelined collectives (the
        # BASELINE config-5 shape: spectrum -> padded physical -> spectrum)
        FFTp = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), None, "single",
                          communication="pipelined")
        fwd32, bwd32 = FFTp.forward_fn("3/2-rule"), FFTp.backward_fn("3/2-rule")
        fu0 = FFTp.shard_complex(FFT.gather(fu))
        t = measure(lambda f: fwd32(bwd32(f)), fu0)
        report("5_pencil_dns_overlapped_padded", FFTp, t, err)

    print(json.dumps({"summary": results}))
    if "--out" in sys.argv:
        path = sys.argv[sys.argv.index("--out") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"backend": jax.default_backend(), "devices": ndev,
                       "smoke": smoke, "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
