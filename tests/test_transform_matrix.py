"""Transform oracle matrix: every decomposition × dealias rule ×
communication against numpy float64.

Decompositions: slab P ∈ {1, 2, 4}, pencil 2×2 and 1×4, line P ∈ {1, 2, 4}.
Dealias: None (forward vs ``numpy.fft.rfftn``/``rfft2`` and the round trip),
"2/3-rule" (forward vs the numpy spectrum with the mask applied in numpy),
"3/2-rule" (a Nyquist-free spectrum zero-padded in numpy and inverted on the
1.5× grid must match the padded inverse; the padded forward must return the
spectrum).  Float64 throughout, so the tolerance is round-off.
"""

import numpy as np
import pytest

from mpifft4py_tpu import line, pencil, slab
from mpifft4py_tpu.utils.spectral import dealias_cutoffs

TAU = 2 * np.pi
N = 16
TOL = 1e-12

DECOMPS = ("slab1", "slab2", "slab4", "pencil2x2", "pencil1x4",
           "line1", "line2", "line4")


def make(decomp, communication):
    kw = dict(communication=communication)
    if decomp.startswith("slab"):
        return slab.R2C(np.array([N] * 3), np.array([TAU] * 3),
                        int(decomp[4:]), "double", **kw)
    if decomp.startswith("pencil"):
        p1 = int(decomp[6])
        return pencil.R2C(np.array([N] * 3), np.array([TAU] * 3), 4, "double",
                          P1=p1, **kw)
    return line.R2C(np.array([N] * 2), np.array([TAU] * 2), int(decomp[4:]),
                    "double", **kw)


def fwd(FFT, x, dealias=None):
    return FFT.fft2(x, dealias=dealias) if FFT.ndim == 2 \
        else FFT.fftn(x, dealias=dealias)


def bwd(FFT, x, dealias=None):
    return FFT.ifft2(x, dealias=dealias) if FFT.ndim == 2 \
        else FFT.ifftn(x, dealias=dealias)


def mask(ndim):
    """2/3-rule mask over the rfftn layout, built in numpy."""
    c = dealias_cutoffs([N] * ndim)
    k = np.abs(np.fft.fftfreq(N, 1.0 / N))
    kh = np.arange(N // 2 + 1)
    if ndim == 2:
        return (k[:, None] < c[0]) & (kh[None, :] < c[1])
    return ((k[:, None, None] < c[0]) & (k[None, :, None] < c[1])
            & (kh[None, None, :] < c[2]))


def pad(fu, M):
    """Zero-pad a Nyquist-free rfftn spectrum from the N to the M grid."""
    h = N // 2
    src = np.r_[0:h, h + 1:N]
    dst = np.r_[0:h, M - h + 1:M]
    full_axes = fu.ndim - 1
    out = np.zeros((M,) * full_axes + (M // 2 + 1,), fu.dtype)
    out[np.ix_(*([dst] * full_axes), np.arange(h))] = \
        fu[np.ix_(*([src] * full_axes), np.arange(h))]
    return out


def spectrum(FFT, fu):
    """Host spectrum with the alignment padding (pencil/line Nfp) removed."""
    return FFT.gather(fu)[..., :N // 2 + 1]


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("communication", ["alltoall", "pipelined"])
@pytest.mark.parametrize("dealias", [None, "2/3-rule", "3/2-rule"])
@pytest.mark.parametrize("decomp", DECOMPS)
def test_oracle(rng, decomp, dealias, communication):
    FFT = make(decomp, communication)
    nd = FFT.ndim
    u = rng.standard_normal((N,) * nd)
    ref = np.fft.rfftn(u)
    if dealias is None:
        fu = fwd(FFT, u)
        assert rel(spectrum(FFT, fu), ref) < TOL
        assert rel(np.asarray(bwd(FFT, fu)), u) < TOL
    elif dealias == "2/3-rule":
        m = mask(nd)
        assert rel(spectrum(FFT, fwd(FFT, u, dealias)), np.where(m, ref, 0)) < TOL
    else:
        ref0 = ref.copy()
        for ax in range(nd):        # drop every Nyquist plane
            idx = [slice(None)] * nd
            idx[ax] = N // 2
            ref0[tuple(idx)] = 0
        M = 3 * N // 2
        up_ref = np.fft.irfftn(pad(ref0, M), s=(M,) * nd,
                               axes=tuple(range(nd))) * 1.5 ** nd
        nfp = FFT.global_complex_shape()[-1]
        spec = np.zeros(ref0.shape[:-1] + (nfp,), ref0.dtype)
        spec[..., :N // 2 + 1] = ref0
        up = bwd(FFT, FFT.shard_complex(spec), dealias)
        assert rel(np.asarray(up), up_ref) < TOL
        assert rel(spectrum(FFT, fwd(FFT, up, dealias)), ref0) < TOL
