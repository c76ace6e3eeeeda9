"""Headline benchmark: 3D r2c+c2r round trip on the available devices.

Driver metric (BASELINE.json): "3D r2c+c2r round-trip time at 256^3/1024^3;
transpose GB/s/chip".  On one device the slab transform runs its local
stages only; on a multi-device mesh the slab transposes engage.

Prints the card's ``nvidia-smi`` name and power limit on one line, then ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
``vs_baseline`` is the speedup of this framework's round trip vs raw XLA
``jnp.fft.rfftn``+``irfftn`` on the same devices — >1.0 means we beat the
stock path.  ``BENCH_N`` sets the grid (default 256).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def _timeit(fn, x, iters=50):
    """Per-iteration device time of x -> fn(x), measured as a data-dependent
    in-jit chain ending in a scalar fetch, so one dispatch and one readback
    are spread over ``iters`` applications."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    chain = jax.jit(lambda v: jnp.sum(
        lax.scan(lambda c, _: (fn(c), None), v, None, length=iters)[0]))
    float(chain(x))  # warm: compile + execute once
    t0 = time.perf_counter()
    s = float(chain(x))
    dt = (time.perf_counter() - t0) / iters
    assert s == s, "NaN in benchmark chain"
    return dt


def main():
    from mpifft4py_tpu.utils.cache import enable_wisdom_cache
    enable_wisdom_cache()
    import jax
    import jax.numpy as jnp
    from mpifft4py_tpu.slab import R2C

    n = int(os.environ.get("BENCH_N", "256"))
    N = np.array([n, n, n])
    L = np.array([2 * np.pi] * 3)
    ndev = len(jax.devices())
    FFT = R2C(N, L, None, "single")

    u = FFT.shard_real(np.random.default_rng(0).standard_normal(tuple(N)).astype(np.float32))

    fwd, bwd = FFT.forward_fn(), FFT.backward_fn()
    t_ours = _timeit(lambda v: bwd(fwd(v)), u)

    # Baseline: stock XLA FFT (what a naive JAX port of the reference would do).
    # Multi-device: the same jnp.fft program jitted over the same sharded input
    # (GSPMD inserts its own collectives) — a genuine sharded-XLA baseline,
    # never t_base = t_ours (which would fabricate vs_baseline = 1.0).
    shape = tuple(int(x) for x in N)
    t_base = None
    if not os.environ.get("BENCH_SKIP_BASELINE"):
        try:
            base = lambda v: jnp.fft.irfftn(jnp.fft.rfftn(v), s=shape)
            if ndev > 1:
                out_sh = FFT.real_sharding()
                base_s = lambda v: jax.lax.with_sharding_constraint(
                    jnp.fft.irfftn(jnp.fft.rfftn(v), s=shape), out_sh)
                t_base = _timeit(base_s, u)
            else:
                t_base = _timeit(base, u)
        except Exception as e:  # e.g. out of device memory at large N
            print(f"# baseline XLA fft failed ({type(e).__name__}); "
                  f"reporting vs_baseline=0 (baseline unavailable)", file=sys.stderr)

    dev = jax.devices()[0]
    from mpifft4py_tpu.utils.profiling import card_line
    print(f"# card: {card_line()}")
    print(json.dumps({
        "metric": f"3d_r2c_c2r_roundtrip_{n}cubed",
        "value": round(t_ours * 1e3, 3),
        "unit": "ms",
        "vs_baseline": 0.0 if t_base is None else round(t_base / t_ours, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": ndev},
    }))


if __name__ == "__main__":
    main()
