"""On-card smoke test: the library's main paths on an NVIDIA GPU, checked.

Runs the public entry points (``slab``/``line`` ``R2C`` and the
``NavierStokes3D`` solver) at the sizes users of a distributed spectral code
run, compares each with a plain numpy/float64 or analytic reference, and
prints one line per phase with its size, error, tolerance, time and the card.

    python chip_smoke.py            # one card: phases 1-5
    python chip_smoke.py --multi    # four cards: slab P=4 and pencil 2x2 only

It refuses to run without a GPU (no CPU fallback) and any failed phase makes
the exit code nonzero.  A run that outlives ``DEADLINE_S`` dumps every
thread's Python stack to standard error and exits nonzero, so a hang names
its place instead of running into the caller's time limit; each phase
announces its start on standard error for the same reason.  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Timings are printed for the record; they are not a benchmark.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TAU = 2 * np.pi
NVLINK_GBPS_EACH_WAY = 450.0     # H100 SXM data sheet: 900 GB/s total
TOL_FP32 = 1e-6                  # BASELINE: max relative error, fp32
TOL_FP64 = 1e-12                 # BASELINE: max relative error, fp64
# 1024³ round trip, max norm: fp32 FFT error grows like ε·log N; H100 readings
# 6.2e-7 (256³), 7.0e-7 (512³), 1.14e-6 and 1.21e-6 (1024³), bitwise the same
# for one 3-D cuFFT plan.  The RMS error is still held to TOL_FP32.
TOL_RT_MAX_1024 = 2e-6
TOL_DNS = 1e-5                   # fp32 sums over 512³ modes
DEADLINE_S = 1100                # a run must end within 1200 s, compiles included


class PhaseError(AssertionError):
    """A phase's result missed its tolerance."""


def check(name: str, err: float, tol: float) -> None:
    if not err < tol:            # also catches NaN
        raise PhaseError(f"{name}: error {err:.3e} not below {tol:.0e}")


def rel(a, b) -> float:
    """max|a - b| / max|b| on host arrays."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def _devices(n):
    import jax
    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, JAX sees {len(devs)}")
    return devs[:n]


def progress(what: str) -> None:
    """Start marker on standard error, so a hang names its place."""
    print(f"chip_smoke: starting {what}", file=sys.stderr, flush=True)


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# -- analytic fields: a seeded sum of Fourier modes with a known spectrum ------

def analytic_modes(n: int, seed: int, count: int = 8):
    """``count`` distinct wavevectors k (k2 in 1..n/2-1, |k0|,|k1| < n/2) and
    complex amplitudes A; the field u = Σ 2·Re(A·e^{ik·x}) has rfftn
    coefficient exactly n³·A at each k and zero elsewhere."""
    rng = np.random.default_rng(seed)
    ks = set()
    while len(ks) < count:
        ks.add((int(rng.integers(-n // 2 + 1, n // 2)),
                int(rng.integers(-n // 2 + 1, n // 2)),
                int(rng.integers(1, n // 2))))
    ks = np.array(sorted(ks), dtype=np.int64)
    amps = rng.standard_normal(count) + 1j * rng.standard_normal(count)
    return ks, amps


def analytic_field_fn(n: int, ks, amps, dtype):
    """Jittable builder of the analytic field on the n³ grid.  The phase
    k·j is reduced mod n in integer arithmetic, so the angle stays in
    [0, 2π) and float32 loses nothing to large arguments."""
    import jax.numpy as jnp

    def build():
        j = jnp.arange(n, dtype=jnp.int32)
        u = jnp.zeros((n, n, n), dtype)
        for (k0, k1, k2), a in zip(ks.tolist(), amps.tolist()):
            p = ((k0 % n) * j[:, None, None] + (k1 % n) * j[None, :, None]
                 + k2 * j[None, None, :]) % n
            th = p.astype(dtype) * dtype(TAU / n)
            u = u + dtype(2 * a.real) * jnp.cos(th) - dtype(2 * a.imag) * jnp.sin(th)
        return u
    return build


def spectrum_errors(FFT, u, ks, amps):
    """(max error at the listed modes, max |X| elsewhere), both over n³, of
    the forward transform of the analytic field ``u``.  Reductions run on
    device."""
    import jax
    import jax.numpy as jnp
    n = int(FFT.N[0])
    n3 = float(n) ** 3
    idx = (jnp.asarray(ks[:, 0] % n), jnp.asarray(ks[:, 1] % n),
           jnp.asarray(ks[:, 2]))
    coef = jnp.asarray((n3 * amps).astype(FFT.complex))

    @jax.jit
    def errs(X):
        at = jnp.abs(X[idx] - coef).max() / n3
        rest = jnp.abs(X.at[idx].set(0)).max() / n3
        return at, rest

    return tuple(float(v) for v in errs(FFT.fftn(u)))


def random_field(FFT, seed: int):
    """Standard-normal float32 field built on the devices, in ``FFT``'s
    physical sharding (the field class of phase 1 and BASELINE)."""
    import jax
    n = int(FFT.N[0])
    return jax.jit(lambda: jax.random.normal(jax.random.key(seed), (n, n, n),
                                             np.float32),
                   out_shardings=FFT.real_sharding())()


def roundtrip_errors(FFT, u):
    """Round-trip error of ``u`` relative to ``u``, reduced on device:
    (RMS, max) = (‖ifftn(fftn(u)) − u‖₂/‖u‖₂, max|…|/max|u|).

    The 1024³ phases hold both: RMS to ``TOL_FP32`` and max to
    ``TOL_RT_MAX_1024``.  1.14e-6 of max|u| ≈ 6σ is about 7e-6, or about
    15 ulp of float32 at that magnitude (ulp 4.8e-7 in [4, 8))."""
    import jax
    import jax.numpy as jnp
    ub = FFT.ifftn(FFT.fftn(u))
    rms, mx = jax.jit(lambda a, b: (
        jnp.sqrt(jnp.sum((a - b) ** 2) / jnp.sum(b * b)),
        jnp.abs(a - b).max() / jnp.abs(b).max()))(ub, u)
    return float(rms), float(mx)


# -- phase 1: slab.R2C 256³ fp32 against numpy, with both dealias rules --------

def numpy_pad(fu, M):
    """Zero-pad an rfftn spectrum with zero Nyquist planes from N to the M
    grid (the 3/2-rule oracle)."""
    n = fu.shape[0]
    h = n // 2
    src = np.r_[0:h, h + 1:n]
    dst = np.r_[0:h, M - h + 1:M]
    out = np.zeros((M, M, M // 2 + 1), fu.dtype)
    out[np.ix_(dst, dst, np.arange(h))] = fu[np.ix_(src, src, np.arange(h))]
    return out


def phase_slab(n: int = 256, seed: int = 0) -> dict:
    from mpifft4py_tpu import slab
    from mpifft4py_tpu.utils.profiling import measure
    from mpifft4py_tpu.utils.spectral import dealias_cutoffs
    FFT = slab.R2C(np.array([n] * 3), np.array([TAU] * 3), _devices(1), "single")
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, n, n)).astype(np.float32)
    ref = np.fft.rfftn(u.astype(np.float64))
    out = {"N": n, "tol": TOL_FP32}
    ud = FFT.shard_real(u)
    fu = FFT.fftn(ud)
    out["fwd"] = rel(FFT.gather(fu), ref)
    out["roundtrip"] = rel(FFT.gather(FFT.ifftn(fu)), u)
    # 2/3-rule: the mask applied in numpy
    k = np.fft.fftfreq(n, 1.0 / n)
    c = dealias_cutoffs([n] * 3)
    mask = ((np.abs(k)[:, None, None] < c[0]) & (np.abs(k)[None, :, None] < c[1])
            & (np.arange(n // 2 + 1)[None, None, :] < c[2]))
    out["fwd_23"] = rel(FFT.gather(FFT.fftn(ud, dealias="2/3-rule")),
                        np.where(mask, ref, 0))
    # 3/2-rule: a Nyquist-free spectrum, padded in numpy, must match the
    # padded inverse; the padded forward must return the spectrum
    ref0 = ref.copy()
    ref0[n // 2] = 0
    ref0[:, n // 2] = 0
    ref0[..., n // 2] = 0
    M = int(1.5 * n)
    up_ref = np.fft.irfftn(numpy_pad(ref0, M), s=(M, M, M),
                           axes=(0, 1, 2)) * 1.5 ** 3
    up = FFT.ifftn(FFT.shard_complex(ref0), dealias="3/2-rule")
    out["bwd_32"] = rel(FFT.gather(up), up_ref)
    out["fwd_32"] = rel(FFT.gather(FFT.fftn(up, dealias="3/2-rule")), ref0)
    for key in ("fwd", "roundtrip", "fwd_23", "bwd_32", "fwd_32"):
        check(f"slab {n}³ {key}", out[key], TOL_FP32)
    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    out["roundtrip_ms"] = measure(lambda v: bwd(fwd(v)), ud) * 1e3
    return out


# -- phase 2: slab.R2C 1024³ fp32 at P=1 on an analytic field -------------------

def phase_slab_big(n: int = 1024, seed: int = 1) -> dict:
    import jax
    from mpifft4py_tpu import slab
    from mpifft4py_tpu.utils.profiling import measure
    dev = _devices(1)
    FFT = slab.R2C(np.array([n] * 3), np.array([TAU] * 3), dev, "single")
    ks, amps = analytic_modes(n, seed)
    u = jax.jit(analytic_field_fn(n, ks, amps, np.float32),
                out_shardings=FFT.real_sharding())()
    at, rest = spectrum_errors(FFT, u, ks, amps)
    rms, mx = roundtrip_errors(FFT, random_field(FFT, seed))
    out = {"N": n, "modes": at, "others": rest, "roundtrip_rms": rms,
           "roundtrip_max": mx, "tol": TOL_FP32,
           "tol_roundtrip_max": TOL_RT_MAX_1024}
    check(f"slab {n}³ listed modes", at, TOL_FP32)
    check(f"slab {n}³ other modes", rest, TOL_FP32)
    check(f"slab {n}³ roundtrip (RMS)", rms, TOL_FP32)
    check(f"slab {n}³ roundtrip (max)", mx, TOL_RT_MAX_1024)
    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    ma = jax.jit(lambda v: bwd(fwd(v))).lower(u).compile().memory_analysis()
    out["memory_analysis"] = _mem(ma)
    out["roundtrip_ms"] = measure(lambda v: bwd(fwd(v)), u) * 1e3
    stats = dev[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def _mem(ma) -> dict:
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "alias_size_in_bytes", "temp_size_in_bytes")}


# -- phase 3: "double" at 64³, native and doubleword ------------------------------

def phase_double(n: int = 64, seed: int = 2) -> dict:
    from mpifft4py_tpu import slab
    dev = _devices(1)
    L = np.array([TAU] * 3)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, n, n))
    ref = np.fft.rfftn(u)
    FFT = slab.R2C(np.array([n] * 3), L, dev, "double")
    if FFT.policy.path != "native" or FFT.float != np.float64:
        raise PhaseError(f'"double" resolved to {FFT.policy.path}/{FFT.float}, '
                         "want native/float64")
    fu = FFT.fftn(u)
    out = {"N": n, "path": FFT.policy.path, "tol": TOL_FP64,
           "fwd": rel(FFT.gather(fu), ref),
           "roundtrip": rel(FFT.gather(FFT.ifftn(fu)), u)}
    check(f"double {n}³ fwd", out["fwd"], TOL_FP64)
    check(f"double {n}³ roundtrip", out["roundtrip"], TOL_FP64)
    # the emulated path, for the record only
    dd = slab.R2C(np.array([n] * 3), L, dev, "double", fp64_mode="doubleword")
    fd = dd.fftn(u)
    out["doubleword_fwd"] = rel(dd.gather_dd(fd), ref)
    out["doubleword_roundtrip"] = rel(dd.gather_dd(dd.ifftn(fd)), u)
    return out


# -- phase 4: line.R2C 512² -------------------------------------------------------

def phase_line(n: int = 512, seed: int = 3) -> dict:
    from mpifft4py_tpu import line
    from mpifft4py_tpu.utils.profiling import measure
    FFT = line.R2C(np.array([n, n]), np.array([TAU, TAU]), _devices(1), "single")
    u = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    ud = FFT.shard_real(u)
    fu = FFT.fft2(ud)
    out = {"N": n, "tol": TOL_FP32,
           "fwd": rel(FFT.gather(fu)[:, :FFT.Nf], np.fft.rfft2(u.astype(np.float64))),
           "roundtrip": rel(FFT.gather(FFT.ifft2(fu)), u)}
    check(f"line {n}² fwd", out["fwd"], TOL_FP32)
    check(f"line {n}² roundtrip", out["roundtrip"], TOL_FP32)
    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    out["roundtrip_ms"] = measure(lambda v: bwd(fwd(v)), ud) * 1e3
    return out


# -- phase 5: NavierStokes3D Taylor–Green, RK4, 2/3-rule --------------------------

TG = dict(nu=1.0 / 1600.0, dt=0.005, dealias="2/3-rule")


def tg_energy_history(n: int, precision: str, steps: int, integrator: str,
                      devices, timed: bool = False) -> dict:
    """E(t) of the Taylor–Green run through ``solver.run`` (monitor every
    step).  ``timed`` runs it twice and times the second (compiled) run."""
    import jax
    from mpifft4py_tpu import slab
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    FFT = slab.R2C(np.array([n] * 3), np.array([TAU] * 3), devices, precision)
    solver = NavierStokes3D(FFT, integrator=integrator, **TG)
    out = {}
    U, E = solver.run(solver.taylor_green(), steps, monitor_every=1)
    if timed:
        U0 = jax.block_until_ready(solver.taylor_green())
        (U, E), dt = _timed(lambda s: solver.run(s, steps, monitor_every=1), U0)
        out["ms_per_step"] = dt / steps * 1e3
        ma = jax.jit(solver.step_fn()).lower(U, *solver._step_args()) \
            .compile().memory_analysis()
        out["memory_analysis"] = _mem(ma)
    out["E"] = np.asarray(E, np.float64)
    return out


def is_out_of_memory(e: Exception) -> bool:
    return "RESOURCE_EXHAUSTED" in str(e) or "out of memory" in str(e).lower()


def phase_dns(n: int = 512, n_ref: int = 64, steps: int = 10) -> dict:
    dev = _devices(1)
    integ = "RK4"
    try:
        big = tg_energy_history(n, "single", steps, integ, dev, timed=True)
    except Exception as e:  # noqa: BLE001 — only an out-of-memory falls back
        if not is_out_of_memory(e):
            raise
        stats = dev[0].memory_stats() or {}
        print(f"# dns {n}³ RK4 out of device memory (peak "
              f"{stats.get('peak_bytes_in_use')} B); falling back to LSRK54",
              flush=True)
        integ = "LSRK54"
        big = tg_energy_history(n, "single", steps, integ, dev, timed=True)
    ref = tg_energy_history(n_ref, "double", steps, integ, dev)
    big.update({"N": n, "N_ref": n_ref, "integrator": integ, "steps": steps,
                "E_rel_diff": rel(big["E"], ref["E"]), "tol": TOL_DNS})
    check(f"dns {n}³ vs {n_ref}³ float64 E(t)", big["E_rel_diff"], TOL_DNS)
    return big


# -- four cards: slab P=4 and pencil 2x2 ------------------------------------------

def count_all_to_all(hlo: str) -> int:
    """All-to-all collectives in compiled HLO text (an async start/done pair
    counts once)."""
    import re
    return len(re.findall(r"\sall-to-all(?:-start)?\(", hlo))


def _make_fft(kind: str, n: int, devices, communication: str, precision="single"):
    from mpifft4py_tpu import pencil, slab
    N, L = np.array([n] * 3), np.array([TAU] * 3)
    if kind == "slab":
        return slab.R2C(N, L, devices, precision, communication=communication)
    return pencil.R2C(N, L, devices, precision, P1=2, communication=communication)


def phase_multi_transforms(n: int = 1024, ndev: int = 4, seed: int = 4) -> list:
    import jax
    from mpifft4py_tpu.utils.profiling import stage_report
    devs = _devices(ndev)
    ks, amps = analytic_modes(n, seed)
    rows = []
    for kind in ("slab", "pencil"):
        for comm in ("alltoall", "pipelined"):
            FFT = _make_fft(kind, n, devs, comm)
            name = f"{kind} P={dict(FFT.mesh.shape)} {comm} {n}³"
            progress(name)
            u = jax.jit(analytic_field_fn(n, ks, amps, np.float32),
                        out_shardings=FFT.real_sharding())()
            at, rest = spectrum_errors(FFT, u, ks, amps)
            rms, mx = roundtrip_errors(FFT, random_field(FFT, seed))
            check(f"{name} listed modes", at, TOL_FP32)
            check(f"{name} other modes", rest, TOL_FP32)
            check(f"{name} roundtrip (RMS)", rms, TOL_FP32)
            check(f"{name} roundtrip (max)", mx, TOL_RT_MAX_1024)
            row = {"name": name, "modes": at, "others": rest,
                   "roundtrip_rms": rms, "roundtrip_max": mx, "tol": TOL_FP32,
                   "tol_roundtrip_max": TOL_RT_MAX_1024}
            if comm == "alltoall":
                want = 1 if kind == "slab" else 2
                fwd = jax.jit(FFT.forward_fn()).lower(u).compile().as_text()
                X = FFT.fftn(u)
                bwd = jax.jit(FFT.backward_fn()).lower(X).compile().as_text()
                row["a2a_fwd"] = count_all_to_all(fwd)
                row["a2a_bwd"] = count_all_to_all(bwd)
                if (row["a2a_fwd"], row["a2a_bwd"]) != (want, want):
                    raise PhaseError(f"{name}: all-to-alls per direction "
                                     f"{row['a2a_fwd']}/{row['a2a_bwd']}, "
                                     f"want {want}")
                del X
            rep = stage_report(FFT, u=u)
            row["roundtrip_ms"] = rep["roundtrip_ms"]
            row["transpose_GBps_per_card"] = rep["transpose_GBps_chip"]
            rows.append(row)
            del u
    return rows


def phase_multi_dns(n: int = 512, ndev: int = 4) -> list:
    """One TG RK4 step at n³ on slab P=ndev and pencil 2x(ndev/2), compared
    with the same step on card 0 alone."""
    import jax
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    devs = _devices(ndev)

    def one_step(FFT):
        s = NavierStokes3D(FFT, integrator="RK4", **TG)
        U = s.step(s.taylor_green())
        e = s.energy(U)
        return np.asarray(jax.device_get(U))[..., :n // 2 + 1], e

    progress(f"dns slab P=1 {n}³")
    U1, e1 = one_step(_make_fft("slab", n, devs[:1], "alltoall"))
    scale = np.abs(U1).max()
    rows = []
    for kind in ("slab", "pencil"):
        FFT = _make_fft(kind, n, devs, "alltoall")
        progress(f"dns {kind} P={dict(FFT.mesh.shape)} {n}³")
        U, e = one_step(FFT)
        row = {"name": f"dns {kind} P={dict(FFT.mesh.shape)} {n}³",
               "E_rel": abs(e - e1) / abs(e1),
               "U_rel": float(np.abs(U - U1).max() / scale), "tol": TOL_DNS}
        check(f"{row['name']} energy", row["E_rel"], TOL_DNS)
        check(f"{row['name']} state", row["U_rel"], TOL_DNS)
        rows.append(row)
    return rows


# -- main --------------------------------------------------------------------------

def _fmt(x) -> str:
    return f"{x:.3e}" if isinstance(x, float) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card slab/pencil path")
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True,
                                      file=sys.__stderr__)
    try:
        return _run(args)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _run(args) -> int:
    import jax
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev0.platform!r}); "
              "this test runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mpifft4py_tpu
    if not os.path.abspath(mpifft4py_tpu.__file__).startswith(HERE + os.sep):
        print("chip_smoke: mpifft4py_tpu not found beside this script",
              file=sys.stderr)
        return 2
    from mpifft4py_tpu.utils.cache import enable_wisdom_cache
    from mpifft4py_tpu.utils.profiling import card_line
    enable_wisdom_cache()
    jax.config.update("jax_enable_x64", True)   # phase 3 and the DNS reference

    card = card_line()
    kind = dev0.device_kind
    print(f"card: {card}", flush=True)

    def line(name, res, t):
        body = "  ".join(f"{k}={_fmt(v)}" for k, v in res.items()
                         if k not in ("E", "name"))
        print(f"[{name}] {body}  time={t:.1f}s  card={kind} ({card})",
              flush=True)

    if args.multi:
        phases = [("multi transforms", phase_multi_transforms),
                  ("multi dns", phase_multi_dns)]
    else:
        phases = [("1 slab 256³ fp32", phase_slab),
                  ("2 slab 1024³ fp32", phase_slab_big),
                  ("3 double 64³", phase_double),
                  ("4 line 512²", phase_line),
                  ("5 dns 512³ TG", phase_dns)]
    for name, fn in phases:
        progress(f"[{name}]")
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        if isinstance(res, list):
            for r in res:
                line(f"{name}: {r['name']}", r, dt)
        else:
            line(name, res, dt)
    if args.multi:
        print(f"# NVLink reference: {NVLINK_GBPS_EACH_WAY:.0f} GB/s each way "
              "per card (H100 SXM data sheet)")
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
