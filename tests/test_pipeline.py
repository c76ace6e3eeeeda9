"""Pipelined (overlapped transpose/FFT) paths vs the dense-collective paths.

SURVEY.md §7 hard-parts: "chunked pipelines are where silent corruption hides;
land only after vs-unoverlapped tests."  These assert the pipelined slab and
pencil transforms match the dense ones to fp64 roundoff on the 8-device mesh.
"""

import numpy as np
import pytest

from mpifft4py_tpu import slab, pencil

TAU = 2 * np.pi


@pytest.mark.parametrize("nchunks", [2, 3, 4])
def test_slab_pipelined_matches_dense(rng, nchunks):
    N = 16
    args = (np.array([N] * 3), np.array([TAU] * 3), 8, "double")
    dense = slab.R2C(*args)
    piped = slab.R2C(*args, communication="pipelined", pipeline_chunks=nchunks)
    u = rng.standard_normal((N, N, N))
    fu_d = np.asarray(dense.fftn(u))
    fu_p = np.asarray(piped.fftn(u))
    assert np.allclose(fu_p, fu_d, atol=1e-12 * N ** 3)
    ub_d = np.asarray(dense.ifftn(dense.shard_complex(fu_d)))
    ub_p = np.asarray(piped.ifftn(piped.shard_complex(fu_d)))
    assert np.allclose(ub_p, ub_d, atol=1e-13)
    assert np.allclose(ub_p, u, atol=1e-12)


@pytest.mark.parametrize("P1", [2, 4])
def test_pencil_pipelined_matches_dense(rng, P1):
    N = 16
    kw = dict(P1=P1)
    dense = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double", **kw)
    piped = pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 8, "double",
                       communication="pipelined", pipeline_chunks=3, **kw)
    u = rng.standard_normal((N, N, N))
    fu_d = np.asarray(dense.fftn(u))
    fu_p = np.asarray(piped.fftn(u))
    assert np.allclose(fu_p, fu_d, atol=1e-12 * N ** 3)
    ub_p = np.asarray(piped.ifftn(piped.shard_complex(fu_d)))
    assert np.allclose(ub_p, u, atol=1e-12)


@pytest.mark.parametrize("cls", ["slab", "pencilX", "pencilY"])
def test_pipelined_padded_matches_dense(rng, cls):
    """3/2-rule padded transforms with overlapped collectives == dense padded
    (BASELINE config 5 is a *dealiased* overlapped loop)."""
    N = 16
    args = (np.array([N] * 3), np.array([TAU] * 3), 8, "double")
    if cls == "slab":
        dense = slab.R2C(*args)
        piped = slab.R2C(*args, communication="pipelined", pipeline_chunks=3)
    else:
        al = "X" if cls == "pencilX" else "Y"
        dense = pencil.R2C(*args, P1=2, alignment=al)
        piped = pencil.R2C(*args, P1=2, alignment=al,
                           communication="pipelined", pipeline_chunks=3)
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(dense.fftn(u))
    up_d = np.asarray(dense.ifftn(dense.shard_complex(fu), dealias="3/2-rule"))
    up_p = np.asarray(piped.ifftn(piped.shard_complex(fu), dealias="3/2-rule"))
    assert np.allclose(up_p, up_d, atol=1e-13)
    fu2_d = np.asarray(dense.fftn(up_d, dealias="3/2-rule"))
    fu2_p = np.asarray(piped.fftn(up_d, dealias="3/2-rule"))
    assert np.allclose(fu2_p, fu2_d, atol=1e-13 * N ** 3)
    assert np.allclose(fu2_p, fu, atol=1e-12 * N ** 3)  # and it's still exact


@pytest.mark.parametrize("dealias", [None, "3/2-rule"])
def test_line_pipelined_matches_dense(rng, dealias):
    """2D line transform has no free third axis: pipelining chunks the
    per-device blocks of the split/concat axes (collectives block_chunking)."""
    from mpifft4py_tpu import line

    N = 32
    args = (np.array([N, N]), np.array([TAU, TAU]), 8, "double")
    dense = line.R2C(*args)
    piped = line.R2C(*args, communication="pipelined", pipeline_chunks=3)
    u = rng.standard_normal((N, N))
    fu_d = np.asarray(dense.fft2(u, dealias=dealias))
    fu_p = np.asarray(piped.fft2(u, dealias=dealias))
    assert np.allclose(fu_p, fu_d, atol=1e-13 * N ** 2)
    ub_d = np.asarray(dense.ifft2(dense.shard_complex(fu_d), dealias=dealias))
    ub_p = np.asarray(piped.ifft2(piped.shard_complex(fu_d), dealias=dealias))
    assert np.allclose(ub_p, ub_d, atol=1e-13)


def test_doubleword_pipelined_matches_dense(rng):
    """The dd (two-float32 pytree) fields ride the pipelined transpose too."""
    N = 16
    args = (np.array([N] * 3), np.array([TAU] * 3), 8, "double")
    dense = slab.R2C(*args, fp64_mode="doubleword")
    piped = slab.R2C(*args, fp64_mode="doubleword",
                     communication="pipelined", pipeline_chunks=3)
    u = rng.standard_normal((N, N, N))
    fu_d = dense.gather_dd(dense.fftn(u))
    fu_p = piped.gather_dd(piped.fftn(u))
    assert np.allclose(fu_p, fu_d, atol=1e-12 * N ** 3)


def test_pipelined_with_dealias_mask(rng):
    N = 16
    piped = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double",
                     communication="pipelined")
    u = rng.standard_normal((N, N, N))
    fu = np.asarray(piped.fftn(u, dealias="2/3-rule"))
    dense = slab.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double")
    fu_d = np.asarray(dense.fftn(u, dealias="2/3-rule"))
    assert np.allclose(fu, fu_d, atol=1e-12 * N ** 3)


def test_chunk_bounds():
    from mpifft4py_tpu.parallel.collectives import _chunk_bounds

    assert _chunk_bounds(9, 4) == [(0, 3), (3, 2), (5, 2), (7, 2)]
    assert _chunk_bounds(8, 4) == [(0, 2), (2, 2), (4, 2), (6, 2)]
    assert _chunk_bounds(2, 4) == [(0, 1), (1, 1)]
    assert sum(s for _, s in _chunk_bounds(129, 4)) == 129
