"""Solver-family matrix, Navier–Stokes and vorticity–velocity: every integrator on slab P=1, slab
P=4 and pencil 2×2 (cases in family_cases.py)."""

import pytest

from family_cases import DECOMPS, INTEGRATORS, run_case


@pytest.mark.parametrize("decomp", DECOMPS)
@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("model", ["ns", "vv"])
def test_one_step(model, integrator, decomp):
    run_case(model, decomp, integrator)
