"""Checkpoint I/O: save/restore fields and DNS state across shardings."""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil
from mpifft4py_tpu.utils import io

TAU = 2 * np.pi


def test_save_load_field_roundtrip(rng, tmp_path):
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double")
    u = rng.standard_normal((N, N, N))
    fu = FFT.fftn(u)
    p = str(tmp_path / "f.npz")
    io.save_field(p, FFT, fu)
    back = io.load_field(p, FFT)
    assert np.abs(FFT.gather(back) - FFT.gather(fu)).max() == 0
    # physical field too
    io.save_field(p, FFT, FFT.shard_real(u))
    ub = io.load_field(p, FFT)
    assert np.abs(FFT.gather(ub) - u).max() == 0


def test_save_load_state_stack(rng, tmp_path):
    """(3,)+spectral stacks get a None-padded sharding on reload."""
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D

    N = 16
    FFT = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double", P1=2)
    s = NavierStokes3D(FFT, nu=0.01, dt=0.001, dealias="2/3-rule")
    U = s.taylor_green()
    p = str(tmp_path / "state.npz")
    io.save_state(p, FFT, U, step=7, t=0.007)
    U2, meta = io.load_state(p, FFT)
    assert int(meta["step"]) == 7
    assert np.abs(FFT.gather(U2) - FFT.gather(U)).max() == 0
    # restored state must actually run
    e1 = s.energy(s.step(U))
    e2 = s.energy(s.step(U2))
    assert abs(e1 - e2) < 1e-12


def test_load_rejects_wrong_grid(rng, tmp_path):
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 2, "double")
    p = str(tmp_path / "f.npz")
    io.save_field(p, FFT, FFT.shard_real(rng.standard_normal((N, N, N))))
    FFT2 = slab.R2C(np.array([32] * 3), np.array([TAU] * 3), 2, "double")
    with pytest.raises(ValueError, match="grid"):
        io.load_field(p, FFT2)


def test_doubleword_state_io(rng, tmp_path):
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 2, "double",
                   fp64_mode="doubleword")
    u = rng.standard_normal((N, N, N))
    fu = FFT.fftn(u)
    p = str(tmp_path / "dd.npz")
    io.save_field(p, FFT, fu)
    back = io.load_field(p, FFT)
    assert np.abs(FFT.gather_dd(back) - FFT.gather_dd(fu)).max() == 0


def test_regrid_restart_at_higher_resolution(rng, tmp_path):
    """The resolution-change restart workflow: run at 16^3, checkpoint,
    spectrally regrid the saved state to 24^3, continue there.  Energy is
    continuous across the regrid (the interpolant is the same continuum
    field) and the refined run stays stable and divergence-free."""
    import jax.numpy as jnp
    from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
    from mpifft4py_tpu.utils.spectral import regrid

    L = np.array([TAU] * 3)
    F1 = slab.R2C(np.array([16] * 3), L, 4, "double")
    s1 = NavierStokes3D(F1, nu=0.01, dt=0.005, dealias="2/3-rule")
    U = s1.step(s1.taylor_green())
    e_coarse = s1.energy(U)
    p = str(tmp_path / "ckpt.npz")
    io.save_state(p, F1, U, step=1, t=0.005)

    F2 = slab.R2C(np.array([24] * 3), L, 4, "double")
    s2 = NavierStokes3D(F2, nu=0.01, dt=0.005, dealias="2/3-rule")
    U1, meta = io.load_state(p, F1)
    # numpy in -> numpy out: no device transfer
    fu_fine = regrid(F1.gather(U1), (24, 24, 24))
    assert isinstance(fu_fine, np.ndarray)
    U2 = F2.shard_complex(fu_fine)
    assert abs(s2.energy(U2) - e_coarse) < 1e-12  # same continuum field
    U2 = s2.step(U2)
    assert 0 < s2.energy(U2) < e_coarse
    div = jnp.sum(s2.K * U2, axis=0)
    assert float(jnp.abs(div).max()) < 1e-10
