"""Profiling & metrics — the reference has none (SURVEY.md §5: "ABSENT, not
even a logger"); this is the build's observability tier.

* ``measure(fn, x)`` — device timing of ``iters`` applications chained in one
  jitted ``lax.scan`` that ends in a scalar fetch, so the clock stops only
  after the device has finished and one dispatch is spread over the chain.
* ``transpose_stats(FFT)`` — per-transform all-to-all byte counts from the
  decomposition geometry, and achieved GB/s per device given a measured time —
  BASELINE's secondary metric (BASELINE.json: "transpose GB/s/chip").
* ``trace(path)`` — ``jax.profiler`` wrapper for xprof/tensorboard dumps.
* ``card_line()`` — the card's ``nvidia-smi`` name and power limit, printed
  beside every timing so a number carries the hardware it ran on.
* ``stage_report(FFT)`` — one-call round-trip timing + derived transpose
  bandwidth (stages inside one jitted SPMD program are fused by design, so
  the report times the whole pipeline and attributes collective traffic from
  the decomposition geometry).

Quiet by default: nothing here runs unless called (reference stance kept).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["measure", "transpose_stats", "trace", "TransposeStats",
           "stage_report", "card_line"]


def card_line() -> str:
    """``nvidia-smi`` name and power limit of the visible cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.replace("\n", "; ") or "nvidia-smi printed nothing"


def measure(fn: Callable, x, iters: int = 10) -> float:
    """Seconds per application of ``fn`` (shape-preserving), device-timed."""
    def chain_body(v):
        out = lax.scan(lambda c, _: (fn(c), None), v, None, length=iters)[0]
        leaves = jax.tree.leaves(out)
        return sum(jnp.sum(jnp.real(l).astype(jnp.float32)) for l in leaves)
    chain = jax.jit(chain_body)
    float(chain(x))  # compile + warm
    t0 = time.perf_counter()
    float(chain(x))
    return (time.perf_counter() - t0) / iters


@dataclass
class TransposeStats:
    bytes_per_device: int      # all-to-all payload leaving each device, fwd+bwd
    collectives: int           # number of all-to-alls per round trip
    seconds: float             # measured round-trip seconds (0 if not timed)

    @property
    def gb_per_s_per_chip(self) -> float:
        if not self.seconds:
            return 0.0
        return self.bytes_per_device / self.seconds / 1e9


def transpose_stats(FFT, seconds: float = 0.0) -> TransposeStats:
    """All-to-all traffic of one r2c+c2r round trip for a transform object.

    Each tiled all-to-all sends (P-1)/P of the local block; we report the
    egress bytes per device per round trip.
    """
    c = np.dtype(FFT.complex).itemsize
    if hasattr(FFT, "P1"):  # pencil: two grouped all-to-alls per direction
        n0, n1, nf = FFT.complex_shape()
        local = n0 * n1 * nf * c
        frac1 = (FFT.P1 - 1) / FFT.P1
        frac2 = (FFT.P2 - 1) / FFT.P2
        per_dir = local * (frac1 + frac2)
        return TransposeStats(int(2 * per_dir), 4, seconds)
    shape = FFT.complex_shape()
    local = int(np.prod(shape)) * c
    frac = (FFT.P - 1) / FFT.P
    return TransposeStats(int(2 * local * frac), 2, seconds)


def stage_report(FFT, u=None, dealias=None, iters: int = 10) -> dict:
    """Round-trip timing + transpose-bandwidth attribution for a transform.

    Returns {"roundtrip_ms", "per_direction_ms", "a2a_bytes_per_device",
    "collectives_per_roundtrip", "transpose_GBps_chip"}.  ``u`` defaults to a
    random physical field.  Timed with ``measure`` (in-jit scan chain).
    """
    if u is None:
        rng = np.random.default_rng(0)
        # 3/2-rule forward consumes the padded (M) grid — the round trip
        # fwd(3/2) ∘ bwd(3/2) is M-grid-preserving
        shape = (FFT.global_real_shape_padded() if dealias == "3/2-rule"
                 else FFT.global_real_shape())
        host = rng.standard_normal(shape)
        if FFT.policy.path == "doubleword":
            u = FFT.shard_real_dd(host)
        else:
            u = FFT.shard_real(host.astype(FFT.float))
    fwd = FFT.forward_fn(dealias)
    bwd = FFT.backward_fn(dealias if dealias == "3/2-rule" else None)
    t_rt = measure(lambda v: bwd(fwd(v)), u, iters=iters)
    st = transpose_stats(FFT, t_rt)
    return {
        "roundtrip_ms": t_rt * 1e3,
        "per_direction_ms": t_rt * 1e3 / 2,
        "a2a_bytes_per_device": st.bytes_per_device,
        "collectives_per_roundtrip": st.collectives,
        "transpose_GBps_chip": st.gb_per_s_per_chip,
    }


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context (view in xprof / tensorboard)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
