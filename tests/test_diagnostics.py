"""Energy spectrum / dissipation diagnostics + inviscid conservation physics."""

import numpy as np

from mpifft4py_tpu import slab
from mpifft4py_tpu.models.navier_stokes import NavierStokes3D
from mpifft4py_tpu.models.diagnostics import energy_spectrum, dissipation

TAU = 2 * np.pi


def test_spectrum_parseval_consistent():
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double")
    s = NavierStokes3D(FFT, nu=0.01, dt=0.01)
    U = s.taylor_green()
    E = energy_spectrum(FFT, U)
    # TG energy = 0.125, concentrated in the |k| ≈ sqrt(3) shell
    assert abs(E.sum() - 0.125) < 1e-8
    assert E[2] > 0.9 * E.sum()  # round(sqrt(3)) = 2
    eps = dissipation(FFT, U, nu=0.01)
    assert eps > 0


def test_solver_spectrum_matches_diagnostic():
    """SpectralSolver.spectrum bins the velocity components exactly as
    diagnostics.energy_spectrum does, and sums to the solver's energy."""
    shape = (16, 16, 16)
    FFT = slab.R2C(np.array(shape), np.array([TAU] * 3), 4, "double")
    s = NavierStokes3D(FFT, nu=0.01, dt=0.001, dealias="2/3-rule")
    U = s.step(s.taylor_green())      # one step: fill more shells
    E = s.spectrum(U)
    assert np.abs(E - np.asarray(energy_spectrum(FFT, U))).max() == 0.0
    assert abs(E.sum() - s.energy(U)) < 1e-10


def test_inviscid_energy_conservation():
    """nu = 0, dealiased: RK4 conserves energy to integrator order."""
    N = 16
    FFT = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 2, "double")
    s = NavierStokes3D(FFT, nu=0.0, dt=0.005, dealias="2/3-rule")
    U = s.taylor_green()
    e0 = s.energy(U)
    for _ in range(10):
        U = s.step(U)
    e1 = s.energy(U)
    assert abs(e1 - e0) / e0 < 1e-9   # conservative to RK4 truncation order


def test_hermitian_weights_pencil_full_padding(rng):
    """Regression (r2 review): pencil with Nfp == N (alignment padding fills
    the axis) must still get r2c weights, not the c2c unit weights."""
    from mpifft4py_tpu import pencil
    from mpifft4py_tpu.models.diagnostics import _hermitian_weights

    N = 16
    FFT = pencil.R2C(np.array([N] * 3), np.array([2 * np.pi] * 3), 8,
                     "double", P1=1)  # P2=8: Nfp = ceil(9/8)*8 = 16 == N
    assert FFT.Nfp == N
    w = np.asarray(_hermitian_weights(FFT))
    assert w[0] == 1.0 and w[N // 2] == 1.0
    assert np.all(w[1:N // 2] == 2.0)
    assert np.all(w[FFT.Nf:] == 0.0)
