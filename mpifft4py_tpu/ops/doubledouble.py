"""Double-word (two-float32) arithmetic — emulated fp64.

The reference's "double" precision (FFTW fp64 — SURVEY.md §5 config system,
BASELINE.md accuracy target <1e-12) runs natively wherever x64 is enabled;
this module is the alternative selected by ``fp64_mode="doubleword"``:
double-word arithmetic, where every value is an unevaluated sum hi + lo of two
float32 with |lo| <= ulp(hi)/2, giving ~48 mantissa bits (unit roundoff ≈ 2^-48).

Algorithms are the classic error-free transforms (Dekker 1971, Knuth, and the
Bailey/Hida QD library's "ieee" variants), FMA-free so they lower to plain
adds/muls (a compiler that contracts them into FMAs breaks the error-free
property — which is why the policy never picks this path by itself):

* ``two_sum``       — exact a+b = s + e (6 flops)
* ``quick_two_sum`` — exact when |a| >= |b| (3 flops)
* ``split``         — Dekker split of a float32 into 12+12 mantissa bits
                      (constant 2^12+1 = 4097)
* ``two_prod``      — exact a·b = p + e via split (17 flops)

``DD`` is a (hi, lo) array pair with +, -, *, neg; ``DDComplex`` wraps two DDs.
Both are pytrees, so they flow through jit/shard_map/scan and all-to-all
collectives (four f32 payloads) without special casing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

_SPLIT = np.float32(4097.0)  # 2^12 + 1 for float32 Dekker split


def _opaque(x):
    # XLA's algebraic simplifier rewrites patterns like (a+b)-a → b, which is
    # exact in real arithmetic but destroys error-free transforms (measured:
    # dd FFT error degrades from 5e-15 to 2e-8 under jit without this).
    # A barrier hides the producing expression from the simplifier.
    return jax.lax.optimization_barrier(x)


def _same_shape(a, b):
    # Broadcasting inside an EFT lets XLA sink/hoist broadcasts through the
    # compensation expressions and cancel them (measured: lo limbs silently
    # dropped under jit when one operand is rank-deficient).  Pre-broadcast to
    # a common shape and hide the broadcast behind a barrier.
    if jnp.shape(a) != jnp.shape(b):
        a, b = jnp.broadcast_arrays(a, b)
        a, b = _opaque((a, b))
    return a, b


def two_sum(a, b):
    a, b = _same_shape(a, b)
    s = _opaque(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return _opaque((s, e))


def quick_two_sum(a, b):
    a, b = _same_shape(a, b)
    s = _opaque(a + b)
    e = b - (s - a)
    return _opaque((s, e))


def split(a):
    t = _opaque(_SPLIT * a)
    hi = _opaque(t - (t - a))
    lo = a - hi
    return _opaque((hi, lo))


def two_prod(a, b):
    a, b = _same_shape(a, b)
    p = _opaque(a * b)
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return _opaque((p, e))


class DD(NamedTuple):
    """Double-word real array: value = hi + lo (both float32)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    # -- construction -----------------------------------------------------

    @staticmethod
    def from_f64(x) -> "DD":
        """Split host float64 data into (hi, lo) float32 pairs (exact)."""
        x = np.asarray(x, dtype=np.float64)
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return DD(jnp.asarray(hi), jnp.asarray(lo))

    @staticmethod
    def from_f32(x) -> "DD":
        x = jnp.asarray(x, jnp.float32)
        return DD(x, jnp.zeros_like(x))

    def to_f64(self) -> np.ndarray:
        return np.asarray(self.hi, np.float64) + np.asarray(self.lo, np.float64)

    # -- arithmetic (Bailey 'ieee' accuracy) -------------------------------

    def __add__(self, o):
        if not isinstance(o, DD):
            o = DD.from_f32(o)
        s, e = two_sum(self.hi, o.hi)
        t, f = two_sum(self.lo, o.lo)
        e = e + t
        s, e = quick_two_sum(s, e)
        e = e + f
        s, e = quick_two_sum(s, e)
        return DD(s, e)

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def __sub__(self, o):
        if not isinstance(o, DD):
            o = DD.from_f32(o)
        return self + (-o)

    def __mul__(self, o):
        if not isinstance(o, DD):
            o = DD.from_f32(o)
        p, e = two_prod(self.hi, o.hi)
        e = e + (self.hi * o.lo + self.lo * o.hi)
        p, e = quick_two_sum(p, e)
        return DD(p, e)

    # -- shape plumbing ------------------------------------------------------

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    def _map(self, fn) -> "DD":
        return DD(fn(self.hi), fn(self.lo))

    def reshape(self, *s):
        return self._map(lambda a: a.reshape(*s))

    def __getitem__(self, idx):
        return self._map(lambda a: a[idx])


class DDComplex(NamedTuple):
    """Double-word complex array: (re, im), each a DD pair."""

    re: DD
    im: DD

    @staticmethod
    def from_c128(x) -> "DDComplex":
        x = np.asarray(x, np.complex128)
        return DDComplex(DD.from_f64(x.real), DD.from_f64(x.imag))

    @staticmethod
    def from_real_dd(re: DD) -> "DDComplex":
        z = DD(jnp.zeros_like(re.hi), jnp.zeros_like(re.lo))
        return DDComplex(re, z)

    def to_c128(self) -> np.ndarray:
        return self.re.to_f64() + 1j * self.im.to_f64()

    def __add__(self, o):
        return DDComplex(self.re + o.re, self.im + o.im)

    def __sub__(self, o):
        return DDComplex(self.re - o.re, self.im - o.im)

    def __neg__(self):
        return DDComplex(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, DD):  # real scale
            return DDComplex(self.re * o, self.im * o)
        return DDComplex(self.re * o.re - self.im * o.im,
                         self.re * o.im + self.im * o.re)

    def conj(self):
        return DDComplex(self.re, -self.im)

    def mul_i(self):
        """Multiply by i (exact)."""
        return DDComplex(-self.im, self.re)

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def _map(self, fn) -> "DDComplex":
        return DDComplex(self.re._map(fn), self.im._map(fn))

    def reshape(self, *s):
        return self._map(lambda a: a.reshape(*s))

    def __getitem__(self, idx):
        return self._map(lambda a: a[idx])


def dd_where(mask, a: DDComplex, zero_val=0.0) -> DDComplex:
    return a._map(lambda v: jnp.where(mask, v, zero_val))


def dd_stack(items, axis=0):
    """Stack a list of DDComplex along a new axis."""
    re_hi = jnp.stack([it.re.hi for it in items], axis=axis)
    re_lo = jnp.stack([it.re.lo for it in items], axis=axis)
    im_hi = jnp.stack([it.im.hi for it in items], axis=axis)
    im_lo = jnp.stack([it.im.lo for it in items], axis=axis)
    return DDComplex(DD(re_hi, re_lo), DD(im_hi, im_lo))


def dd_concat(items, axis=0):
    re_hi = jnp.concatenate([it.re.hi for it in items], axis=axis)
    re_lo = jnp.concatenate([it.re.lo for it in items], axis=axis)
    im_hi = jnp.concatenate([it.im.hi for it in items], axis=axis)
    im_lo = jnp.concatenate([it.im.lo for it in items], axis=axis)
    return DDComplex(DD(re_hi, re_lo), DD(im_hi, im_lo))


# NamedTuples are pytrees natively — DD/DDComplex flow through jit/shard_map
# without explicit registration.
