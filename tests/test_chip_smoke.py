"""``chip_smoke.py`` on the CPU mesh: every phase at a tiny size (the
arithmetic and control flow the card runs), its helpers, and the refusal to
run without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs


def test_phase_slab():
    r = cs.phase_slab(n=16)
    assert max(r[k] for k in ("fwd", "roundtrip", "fwd_23", "bwd_32",
                              "fwd_32")) < cs.TOL_FP32


def test_phase_slab_big():
    r = cs.phase_slab_big(n=16)
    assert max(r["modes"], r["others"], r["roundtrip_rms"],
               r["roundtrip_max"]) < cs.TOL_FP32
    assert r["memory_analysis"]["argument_size_in_bytes"] == 16 ** 3 * 4


def test_phase_double():
    r = cs.phase_double(n=8)
    assert r["path"] == "native" and max(r["fwd"], r["roundtrip"]) < 1e-12
    assert r["doubleword_fwd"] < 1e-6      # recorded, not asserted, on card


def test_phase_line():
    r = cs.phase_line(n=16)
    assert max(r["fwd"], r["roundtrip"]) < cs.TOL_FP32


def test_phase_dns():
    r = cs.phase_dns(n=32, n_ref=16, steps=3)
    assert r["integrator"] == "RK4" and r["E_rel_diff"] < cs.TOL_DNS
    assert len(r["E"]) == 3 and np.all(np.diff(r["E"]) < 0)


def test_phase_multi_transforms():
    rows = cs.phase_multi_transforms(n=16, ndev=4)
    assert len(rows) == 4
    counts = [(r.get("a2a_fwd"), r.get("a2a_bwd")) for r in rows]
    assert counts == [(1, 1), (None, None), (2, 2), (None, None)]


def test_phase_multi_dns():
    rows = cs.phase_multi_dns(n=16, ndev=4)
    assert [r["name"].split()[1] for r in rows] == ["slab", "pencil"]
    assert max(max(r["E_rel"], r["U_rel"]) for r in rows) < cs.TOL_DNS


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no GPU found" in err


def test_check_rejects_nan_and_misses():
    cs.check("ok", 1e-7, 1e-6)
    for bad in (float("nan"), 1e-6, 2e-6):
        with pytest.raises(cs.PhaseError):
            cs.check("bad", bad, 1e-6)


def test_analytic_field_spectrum_is_exact():
    n = 16
    ks, amps = cs.analytic_modes(n, seed=7)
    u = np.asarray(cs.analytic_field_fn(n, ks, amps, np.float64)())
    X = np.fft.rfftn(u)
    want = np.zeros_like(X)
    want[ks[:, 0] % n, ks[:, 1] % n, ks[:, 2]] = n ** 3 * amps
    assert np.abs(X - want).max() < 1e-9 * n ** 3


def test_numpy_pad_matches_trig_interpolation():
    n, M = 8, 12
    u = np.random.default_rng(0).standard_normal((n, n, n))
    fu = np.fft.rfftn(u)
    fu[n // 2] = 0
    fu[:, n // 2] = 0
    fu[..., n // 2] = 0
    v = np.fft.irfftn(fu, s=(n,) * 3, axes=(0, 1, 2))
    up = np.fft.irfftn(cs.numpy_pad(fu, M), s=(M,) * 3, axes=(0, 1, 2)) \
        * (M / n) ** 3
    assert np.abs(up[::3, ::3, ::3] - v[::2, ::2, ::2]).max() < 1e-12


def test_count_all_to_all():
    hlo = ("%a = f32[4] all-to-all(%x), dimensions={0}\n"
           "%s = (f32[4]) all-to-all-start(%y)\n"
           "%d = f32[4] all-to-all-done(%s)\n"
           "%c = f32[4] copy(%all-to-all.1)\n")
    assert cs.count_all_to_all(hlo) == 2


def test_deadline_dumps_stacks_and_exits_nonzero():
    """A hang past DEADLINE_S ends the run with every thread's stack on
    stderr and a nonzero exit, inside the caller's time limit."""
    import subprocess
    import sys
    code = ("import time, chip_smoke as cs\n"
            "cs.DEADLINE_S = 1\n"
            "cs._run = lambda args: time.sleep(30)\n"
            "raise SystemExit(cs.main([]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=cs.HERE)
    assert p.returncode != 0
    assert "Timeout" in p.stderr and "_run" not in p.stdout
