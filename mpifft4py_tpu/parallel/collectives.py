"""Collective transpose primitives — the framework's communication tier.

Reference analog (SURVEY.md §2.4): mpiFFT4py issues blocking ``MPI_Alltoall``
between local FFT stages.  Here the transpose is ``lax.all_to_all`` on a named
mesh axis inside ``shard_map`` (NCCL on GPUs), with two call styles:

* ``transpose(x, axis_name, split_axis, concat_axis)`` — one dense all-to-all,
  the direct Alltoall analog.  XLA fuses the pack/unpack relayouts the way
  Alltoallw's derived datatypes did.
* ``transpose_pipelined(x, axis_name, split_axis, concat_axis, work_fn,
  pipeline_axis, nchunks)`` — the *overlap* upgrade the reference never had
  (its collectives are blocking): the array is chunked along an axis that is
  independent of both the transpose and the per-chunk compute, and the
  chunk-c collective runs while chunk c−1's FFT computes.  The unrolled
  schedule exposes the overlap to XLA's async collective scheduler, so the
  transpose cost approaches link-bandwidth-bound instead of serialised
  comm+compute (BASELINE config 5).

Both operate on per-device blocks inside shard_map, and both are pytree-aware:
double-word fields (``ops.doubledouble.DD``/``DDComplex`` — four float32
leaves) pipeline exactly like native complex arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["transpose", "transpose_pipelined"]


def transpose(x, axis_name: str, split_axis: int, concat_axis: int):
    """Dense tiled all-to-all: MPI_Alltoall analog on one mesh axis.

    Pytree-aware: each leaf (e.g. the four float32 limbs of a DDComplex)
    rides its own all-to-all.
    """
    return jax.tree.map(
        lambda v: lax.all_to_all(v, axis_name, split_axis=split_axis,
                                 concat_axis=concat_axis, tiled=True), x)


def _chunk_bounds(n: int, k: int):
    """k contiguous chunks covering n (first chunks one larger on remainder)."""
    base, rem = divmod(n, k)
    bounds = []
    start = 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        if size == 0:
            continue
        bounds.append((start, size))
        start += size
    return bounds


def _block_view(v, axis: int, groups: int):
    """Reshape axis (size G·nb) to two axes (G, nb) in place."""
    s = v.shape
    return v.reshape(s[:axis] + (groups, s[axis] // groups) + s[axis + 1:])


def _block_flat(v, axis: int):
    """Inverse of _block_view: merge axes (axis, axis+1)."""
    s = v.shape
    return v.reshape(s[:axis] + (s[axis] * s[axis + 1],) + s[axis + 2:])


def transpose_pipelined(x, axis_name: str, split_axis: int, concat_axis: int,
                        work_fn: Optional[Callable], pipeline_axis: int,
                        nchunks: int = 4, pre_fn: Optional[Callable] = None,
                        block_chunking: Optional[str] = None,
                        group_size: int = 1):
    """Chunked transpose + per-chunk compute, overlappable by XLA.

    ``pre_fn(chunk)`` runs before each chunk's transpose (e.g. the preceding
    FFT stage on the inverse path); ``work_fn(chunk)`` after it; results are
    reassembled along ``pipeline_axis``.  Equivalent (bitwise, per chunk) to
    ``work_fn(transpose(pre_fn(x), ...))`` — tested against the unpipelined
    path.  Pytree-aware (DD/DDComplex limbs ride together).

    Three chunking modes:

    * ``block_chunking=None`` — ``pipeline_axis`` is a free axis, independent
      of ``split_axis``/``concat_axis`` and of ``pre_fn``/``work_fn``'s
      contraction axes (the Hermitian z-axis in the slab/pencil pipelines).
      Plain slice in, plain concat out.
    * ``block_chunking="split"`` — no free axis exists (the 2D line
      transform): chunk the per-device column blocks of ``split_axis``
      (``pipeline_axis`` must equal ``split_axis``).  The input is viewed as
      (…, G, nb, …); chunks slice nb; each chunk's transpose output is a
      contiguous slab of the final ``split_axis``, so outputs concat plainly.
      ``group_size`` = size of the mesh axis (G).
    * ``block_chunking="concat"`` — the mirror (inverse path): chunk the
      input's ``concat_axis`` plainly; each chunk's output holds G interleaved
      blocks, so outputs are reassembled block-interleaved.
    """
    work_fn = work_fn or (lambda v: v)
    pre_fn = pre_fn or (lambda v: v)
    leaves = jax.tree.leaves(x)
    ndim = leaves[0].ndim
    if block_chunking == "split":
        assert pipeline_axis == split_axis
        n = leaves[0].shape[split_axis] // group_size
    else:
        n = leaves[0].shape[pipeline_axis]
    bounds = _chunk_bounds(n, nchunks)
    if len(bounds) <= 1:
        return work_fn(transpose(pre_fn(x), axis_name, split_axis, concat_axis))
    outs = []
    idx = [slice(None)] * ndim
    for start, size in bounds:
        if block_chunking == "split":
            bidx = [slice(None)] * (ndim + 1)
            bidx[split_axis + 1] = slice(start, start + size)
            sl = tuple(bidx)
            chunk = jax.tree.map(
                lambda v: _block_flat(_block_view(v, split_axis, group_size)[sl],
                                      split_axis), x)
        else:
            idx[pipeline_axis] = slice(start, start + size)
            sl = tuple(idx)
            chunk = jax.tree.map(lambda v: v[sl], x)
        y = transpose(pre_fn(chunk), axis_name, split_axis, concat_axis)
        outs.append(work_fn(y))
    if block_chunking == "concat":
        # each chunk output carries G interleaved blocks on concat_axis;
        # reassemble block-wise: (…, G, nb_i, …) concat over nb, then merge.
        outs = [jax.tree.map(lambda v: _block_view(v, concat_axis, group_size), o)
                for o in outs]
        cat = jax.tree.map(
            lambda *vs: jnp.concatenate(vs, axis=concat_axis + 1), *outs)
        return jax.tree.map(lambda v: _block_flat(v, concat_axis), cat)
    return jax.tree.map(lambda *vs: jnp.concatenate(vs, axis=pipeline_axis),
                        *outs)
