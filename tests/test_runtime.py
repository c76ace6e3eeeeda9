"""Runtime scaffolding (multi-process init, DCN-hybrid meshes) and HLO-level
collective audits (dense = exactly 1 (slab) / 2 (pencil) all-to-alls; pipelined
= one per chunk so XLA's async scheduler can straddle them with FFT work)."""

import numpy as np
import pytest

import jax

from mpifft4py_tpu import slab, pencil
from mpifft4py_tpu.parallel import runtime

TAU = 2 * np.pi


class FakeDev:
    """Minimal device stand-in carrying a slice/host id (runtime.hybrid_mesh
    only reads these attributes, so mesh composition is testable offline)."""

    def __init__(self, i, slice_index):
        self.id = i
        self.slice_index = slice_index

    def __repr__(self):
        return f"FakeDev({self.id},s{self.slice_index})"

    def __lt__(self, o):
        return self.id < o.id


def test_hybrid_mesh_composition():
    # 2 granules (hosts) x 4 devices each -> (dcn=2, p1=2, p2=2)
    devs = [FakeDev(i, i // 4) for i in range(8)]
    m = runtime.hybrid_mesh((2, 2), ("p1", "p2"), devices=devs)
    assert m.axis_names == ("dcn", "p1", "p2")
    assert dict(m.shape) == {"dcn": 2, "p1": 2, "p2": 2}
    arr = np.asarray(m.devices)
    # inner axes never cross a slice boundary
    for g in range(2):
        assert {d.slice_index for d in arr[g].ravel()} == {g}


def test_hybrid_mesh_single_granule():
    devs = [FakeDev(i, 0) for i in range(4)]
    m = runtime.hybrid_mesh((2, 2), ("p1", "p2"), devices=devs)
    assert dict(m.shape) == {"dcn": 1, "p1": 2, "p2": 2}


def test_hybrid_mesh_uneven_granules_rejected():
    devs = [FakeDev(i, 0 if i < 3 else 1) for i in range(8)]
    with pytest.raises(ValueError, match="granule"):
        runtime.hybrid_mesh((2, 2), ("p1", "p2"), devices=devs)


def test_initialize_single_process_noop():
    runtime.initialize()  # must not raise on a single-process CPU backend
    assert not runtime.is_initialized() or len(jax.devices()) > 0


def _hlo(FFT, fn, spectral=False):
    shape = FFT.global_complex_shape() if spectral else FFT.global_real_shape()
    dt = FFT.complex if spectral else FFT.float
    x = jax.ShapeDtypeStruct(shape, dt,
                             sharding=(FFT.complex_sharding() if spectral
                                       else FFT.real_sharding()))
    return jax.jit(fn).lower(x).compile().as_text()


def _count(hlo, op):
    return sum(1 for line in hlo.splitlines() if f" {op}(" in line
               or f"{op}-start(" in line)


def test_slab_hlo_one_alltoall():
    FFT = slab.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "single")
    hlo = _hlo(FFT, FFT.forward_fn())
    assert hlo.count("all-to-all") > 0
    assert _count(hlo, "all-to-all") == 1
    for bad in ("all-gather", "all-reduce", "collective-permute"):
        assert _count(hlo, bad) == 0, f"stray {bad} in slab forward HLO"


def test_pencil_hlo_two_alltoalls():
    FFT = pencil.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "single", P1=2)
    hlo = _hlo(FFT, FFT.forward_fn())
    assert _count(hlo, "all-to-all") == 2
    for bad in ("all-gather", "all-reduce", "collective-permute"):
        assert _count(hlo, bad) == 0


def test_pipelined_hlo_chunked_collectives():
    """The pipelined schedule exposes nchunks independent all-to-alls per
    stage — the structural prerequisite for comm/compute overlap (whether
    the scheduler then overlaps them is a device property, read from a
    profiler trace on the card)."""
    nchunks = 4
    FFT = slab.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "single",
                   communication="pipelined", pipeline_chunks=nchunks)
    hlo = _hlo(FFT, FFT.forward_fn())
    assert _count(hlo, "all-to-all") == nchunks
    # each chunk's axis-0 FFT must remain a separate op (not fused into one
    # post-collective blob), otherwise there is nothing to overlap
    FFTd = slab.R2C(np.array([16] * 3), np.array([TAU] * 3), 8, "single")
    hlo_d = _hlo(FFTd, FFTd.forward_fn())
    assert _count(hlo_d, "all-to-all") == 1
