"""Per-shard collective building blocks (used inside shard_map regions).

This is the mxx-replacement vocabulary (SURVEY.md §2 L0/L3): neighbor halos
(``mxx::right_shift``/``left_shift``), the doubling shift
(``shifting.hpp:32-122``), distributed exclusive scans (``mxx::exscan``), and
shard-minima allgathers — all expressed as ``jax.lax`` collectives over the
1-D mesh axis, with static shapes.

All functions here operate on *local* (per-shard) arrays and must be called
inside ``jax.shard_map`` with axis name ``AXIS``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from psac_tpu.parallel.mesh import AXIS


def _perm_shift(p: int, dist: int):
    """ppermute pairs moving data from shard i+dist to shard i (no wraparound)."""
    return [(i + dist, i) for i in range(p - dist)] if dist >= 0 else [(i + dist, i) for i in range(-dist, p)]


def halo_from_right(x, count: int, p: int, fill=0):
    """First ``count`` elements to the right of this shard's block (0 past the global end).

    Equivalent of the k-mer halo ``mxx::left_shift`` in reference
    ``include/kmer.hpp:142``. Supports count > shard size by pulling whole
    blocks from several right neighbors (tiny-input / large-k case).
    """
    s = x.shape[0]
    if count <= s:
        head = lax.slice_in_dim(x, 0, count)
        got = lax.ppermute(head, AXIS, _perm_shift(p, 1))
    else:
        nblocks = -(-count // s)
        parts = [lax.ppermute(x, AXIS, _perm_shift(p, j)) if j < p else jnp.zeros_like(x)
                 for j in range(1, nblocks + 1)]
        got = lax.slice_in_dim(jnp.concatenate(parts), 0, count)
    if fill != 0:
        i = lax.axis_index(AXIS)
        base = (i + 1).astype(
            jax.dtypes.canonicalize_dtype(jnp.int64)) * s  # int32 w/o x64
        gpos = base + jnp.arange(count, dtype=jnp.int32)
        got = jnp.where(gpos < p * s, got, jnp.full_like(got, fill))
    return got


def halo_from_left(x, count: int, p: int, fill=0):
    """Last ``count`` elements of the left neighbor (fill at shard 0).

    Equivalent of ``mxx::right_shift`` one-element halos in reference
    ``include/bucketing.hpp:151``.
    """
    tail = lax.slice_in_dim(x, x.shape[0] - count, x.shape[0])
    got = lax.ppermute(tail, AXIS, _perm_shift(p, -1))
    i = lax.axis_index(AXIS)
    return jnp.where(i == 0, jnp.full_like(got, fill), got)


def global_shift_left(x, d, q: int, p: int):
    """out[g] = x[g + d] over the global index space, 0 past the end.

    ``d = q*s + r`` with the shard-distance ``q`` static (it selects the
    ppermute pattern) and the remainder ``r`` traced. This is the mesh
    equivalent of the reference's ``shift_vector`` doubling shift
    (``include/shifting.hpp:32-122``): at most two neighbor-of-distance-q
    transfers per shard.
    """
    s = x.shape[0]
    if q >= p:
        return jnp.zeros_like(x)
    r = d - q * s
    a = lax.ppermute(x, AXIS, _perm_shift(p, q)) if q > 0 else x
    b = lax.ppermute(x, AXIS, _perm_shift(p, q + 1)) if q + 1 < p else jnp.zeros_like(x)
    # out = concat(a, b)[r : r+s]
    both = jnp.concatenate([a, b])
    return lax.dynamic_slice_in_dim(both, r, s)


def global_shift_left_dyn(x, d, p: int):
    """out[g] = x[g + d] with a *traced* distance d (0 past the global end).

    The fused dense doubling loop carries d in a ``lax.while_loop``, so the
    shard-distance q = d // s is not static.  ppermute patterns must be
    static, so the block shift runs as a ladder of log2(p) conditional
    power-of-two block shifts selected by the bits of q (shifting by q
    blocks == composing shifts by 2^j blocks for q's set bits; the
    zero-fill of non-receiving shards composes correctly), plus one static
    shift-by-1 for the second block and a traced in-shard dynamic slice.
    This is the multi-shard equivalent of the reference's ``shift_vector``
    (``include/shifting.hpp:32-122``) for the one-dispatch construction.
    """
    s = x.shape[0]
    q = (d // s).astype(jnp.int32)
    r = (d - q.astype(d.dtype) * s).astype(jnp.int32)
    if p == 1:
        # local: out = concat(x, 0s)[d : d+s]; slice start clamps to s when
        # d >= s, returning the zero block
        both = jnp.concatenate([x, jnp.zeros_like(x)])
        out = lax.dynamic_slice_in_dim(both, jnp.minimum(r, s), s)
        return jnp.where(q > 0, jnp.zeros_like(out), out)
    oob = q >= p
    qc = jnp.where(oob, 0, q)
    a = x
    j = 1
    while j < p:
        a = lax.cond(
            (qc & j) != 0,
            lambda t, jj=j: lax.ppermute(t, AXIS, _perm_shift(p, jj)),
            lambda t: t,
            a)
        j *= 2
    b = lax.ppermute(a, AXIS, _perm_shift(p, 1))
    both = jnp.concatenate([a, b])
    out = lax.dynamic_slice_in_dim(both, r, s)
    return jnp.where(oob, jnp.zeros_like(out), out)


def exscan_scalar(v, p: int, op: str = "add", init=0):
    """Exclusive scan of one scalar per shard across the axis; returns carry-in.

    Implemented as an allgather of the p scalars plus a masked local reduce —
    the mesh equivalent of ``mxx::exscan`` (tiny, latency-bound).
    """
    all_v = lax.all_gather(v, AXIS)  # (p,)
    i = lax.axis_index(AXIS)
    mask = jnp.arange(p) < i
    if op == "add":
        return jnp.sum(jnp.where(mask, all_v, 0))
    if op == "max":
        return jnp.max(jnp.where(mask, all_v, init))
    if op == "min":
        return jnp.min(jnp.where(mask, all_v, init))
    raise ValueError(op)


def global_index_base(s: int):
    """Global index of this shard's first element.

    Computed in int64 so shard_base = rank*s cannot overflow for >2^31-char
    texts; without jax_enable_x64 (the int32 builds) the astype silently
    stays int32, which is exact there (N < 2^30).
    """
    return lax.axis_index(AXIS).astype(
        jax.dtypes.canonicalize_dtype(jnp.int64)) * s


def global_cummax(x, p: int):
    """Inclusive global prefix-max over a block-distributed array.

    This is the segmented-broadcast used by rebucketing
    (``global_fill_where_zero``, reference ``include/bucketing.hpp:21-53``):
    local cummax plus a shard-level exclusive-max carry.
    """
    local = lax.cummax(x, axis=0)
    carry = exscan_scalar(local[-1], p, op="max", init=jnp.iinfo(x.dtype).min)
    return jnp.maximum(local, carry)


def shard_minima(x, p: int):
    """(p,) array of every shard's min (replicated), cf. par_rmq's per-processor minima."""
    return lax.all_gather(jnp.min(x), AXIS)
