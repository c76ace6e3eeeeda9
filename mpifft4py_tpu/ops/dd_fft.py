"""Mixed-radix FFTs in double-word (emulated fp64) arithmetic.

The emulated "double" precision tier (policy path "doubleword", selected by
``fp64_mode="doubleword"`` or when x64 is off; SURVEY.md §7 step 1 /
BASELINE.md <1e-12 target).  Recursive Cooley–Tukey over
``DDComplex`` arrays with radix-2 and radix-3 butterflies (covering 2^k and the
3/2-rule padded sizes 3·2^k) and a dense O(n²) fallback for other factors.
Twiddles are computed in float64 on host and split exactly into (hi, lo)
float32 pairs, so twiddle error — the usual fp-emulation accuracy killer — is
at the 2^-48 level.

All functions are trace-time recursive (static shapes): the unrolled butterfly
graph is what XLA sees, and it fuses the elementwise stages.  ~20× the flops
of the native-f32 path — the price of 48-bit mantissas from float32 arithmetic.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax.numpy as jnp

from .doubledouble import DD, DDComplex, dd_concat

__all__ = ["fft_dd", "ifft_dd", "rfft_dd", "irfft_dd"]


def _radices(n: int):
    """Factor n into the DIF stage radix sequence (2s then 3s); assert clean."""
    rs = []
    while n % 2 == 0 and n > 1:
        rs.append(2)
        n //= 2
    while n % 3 == 0 and n > 1:
        rs.append(3)
        n //= 3
    if n != 1:
        raise NotImplementedError(
            f"dd FFT supports sizes 2^a·3^b (covers 3/2-rule grids); residue {n}")
    return tuple(rs)


@lru_cache(maxsize=None)
def _perm_np(n: int, radices) -> np.ndarray:
    """Output gather for iterative DIF: result[k] = slots[perm[k]].

    After stage q-branch stacking, slot digits are (q1..qt) MSB-first while the
    output index has them LSB-first with radix weights — mixed-radix digit
    reversal.
    """
    out_of_slot = np.empty(n, np.int64)
    for s in range(n):
        rem = s
        digs = []
        w = n
        for r in radices:
            w //= r
            digs.append(rem // w)
            rem %= w
        k = 0
        wt = 1
        for q, r in zip(digs, radices):
            k += q * wt
            wt *= r
        out_of_slot[s] = k
    slot_of_out = np.argsort(out_of_slot)
    return slot_of_out


@lru_cache(maxsize=None)
def _tw_np(n: int, m: int, sign: int, power: int):
    k = np.arange(m)
    return np.exp(sign * 2j * np.pi * power * k / n)


def _tw(n: int, m: int, sign: int, power: int = 1) -> DDComplex:
    return DDComplex.from_c128(_tw_np(n, m, sign, power))


def _fft_last(x: DDComplex, sign: int) -> DDComplex:
    """Iterative vectorised DIF along the last axis: O(log n) dd-op groups.

    State shape (..., s, c) with s·c = n; each stage splits c by its radix and
    stacks the branch outputs onto s; a final mixed-radix digit-reversal gather
    restores natural order.
    """
    n = x.shape[-1]
    if n == 1:
        return x
    radices = _radices(n)
    lead = x.shape[:-1]
    y = x.reshape(lead + (1, n))
    c = n
    for r in radices:
        m = c // r
        parts = [y[..., p * m:(p + 1) * m] for p in range(r)]  # each (..., s, m)
        if r == 2:
            branches = [parts[0] + parts[1],
                        (parts[0] - parts[1]) * _tw(c, m, sign)]
        else:  # r == 3
            u1 = DDComplex.from_c128(np.exp(sign * 2j * np.pi / 3.0))
            u2 = DDComplex.from_c128(np.exp(sign * 4j * np.pi / 3.0))
            s0 = parts[0] + parts[1] + parts[2]
            s1 = parts[0] + parts[1] * u1 + parts[2] * u2
            s2 = parts[0] + parts[1] * u2 + parts[2] * u1
            branches = [s0,
                        s1 * _tw(c, m, sign),
                        s2 * _tw(c, m, sign, power=2)]
        # stack branches as new sub-axis after s, then fold into s
        stacked = dd_concat([br._map(lambda v: v[..., None, :]) for br in branches],
                            axis=-2)                        # (..., s, r, m)
        s_dim = y.shape[-2] * r
        y = stacked.reshape(lead + (s_dim, m))
        c = m
    y = y.reshape(lead + (n,))
    perm = _perm_np(n, radices)
    return y._map(lambda v: jnp.take(v, jnp.asarray(perm), axis=-1))


def _move_last(x: DDComplex, axis: int):
    axis = axis % x.ndim
    if axis == x.ndim - 1:
        return x, None
    return x._map(lambda a: jnp.moveaxis(a, axis, -1)), axis


def _unmove(x: DDComplex, axis):
    if axis is None:
        return x
    return x._map(lambda a: jnp.moveaxis(a, -1, axis))


def fft_dd(x: DDComplex, axis: int = -1) -> DDComplex:
    """Forward DFT along ``axis`` (unscaled, numpy conventions)."""
    y, ax = _move_last(x, axis)
    return _unmove(_fft_last(y, -1), ax)


def ifft_dd(x: DDComplex, axis: int = -1) -> DDComplex:
    """Inverse DFT along ``axis`` (scaled by 1/n)."""
    y, ax = _move_last(x, axis)
    n = y.shape[-1]
    out = _fft_last(y, +1)
    inv_n = DD.from_f64(np.array(1.0 / n))
    out = DDComplex(out.re * inv_n, out.im * inv_n)
    return _unmove(out, ax)


def _half(a: DD) -> DD:
    return DD(a.hi * np.float32(0.5), a.lo * np.float32(0.5))  # exact


def rfft_dd(x: DD, axis: int = -1) -> DDComplex:
    """Real→complex DFT via the Hermitian pack trick (one n/2 complex FFT)."""
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = x._map(lambda a: jnp.moveaxis(a, axis, -1))
    n = x.shape[-1]
    assert n % 2 == 0, n
    h = n // 2
    z = DDComplex(x[..., 0::2], x[..., 1::2])
    Z = _fft_last(z, -1)
    Zr = dd_concat([Z[..., :1], Z[..., 1:]._map(lambda a: jnp.flip(a, -1))], axis=-1)
    Zc = Zr.conj()
    w = _tw(n, h, -1)
    E = DDComplex(_half((Z + Zc).re), _half((Z + Zc).im))
    Od = (Z - Zc)
    O = DDComplex(_half(Od.im), -_half(Od.re))  # (Z−Zc)/(2i)
    Xk = E + O * w
    ny_re = Z[..., :1].re - Z[..., :1].im       # X[h] = Re(Z0) − Im(Z0), real
    zeros = DD(jnp.zeros_like(ny_re.hi), jnp.zeros_like(ny_re.lo))
    ny = DDComplex(ny_re, zeros)
    out = dd_concat([Xk, ny], axis=-1)
    if axis != out.ndim - 1:
        out = out._map(lambda a: jnp.moveaxis(a, -1, axis))
    return out


def irfft_dd(x: DDComplex, axis: int = -1, n: int | None = None) -> DD:
    """Complex→real inverse DFT (numpy irfft, scaled by 1/n)."""
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        x = x._map(lambda a: jnp.moveaxis(a, axis, -1))
    nf = x.shape[-1]
    if n is None:
        n = 2 * (nf - 1)
    h = n // 2
    assert nf == h + 1, (nf, n)
    Xk = x[..., :h]
    Xr = dd_concat([x[..., h:h + 1], x[..., 1:h]._map(lambda a: jnp.flip(a, -1))],
                   axis=-1)
    Xc = Xr.conj()
    E = DDComplex(_half((Xk + Xc).re), _half((Xk + Xc).im))
    D = (Xk - Xc)
    Dh = DDComplex(_half(D.re), _half(D.im))
    w = _tw(n, h, +1)
    B = (Dh * w).mul_i()                        # i·(w·(Xk−Xc)/2)
    Z = E + B
    z = _fft_last(Z, +1)
    inv_h = DD.from_f64(np.array(1.0 / h))
    zr = z.re * inv_h
    zi = z.im * inv_h
    # interleave even/odd samples
    def ileave(a, b):
        return jnp.stack([a, b], axis=-1).reshape(a.shape[:-1] + (n,))
    out = DD(ileave(zr.hi, zi.hi), ileave(zr.lo, zi.lo))
    if axis != out.ndim - 1:
        out = out._map(lambda a: jnp.moveaxis(a, -1, axis))
    return out
