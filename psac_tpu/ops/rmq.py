"""Vectorized in-shard O(1)-query range-minimum structure.

Vector reformulation of the reference's 3-level succinct RMQ
(``include/rmq.hpp:37-339``): fixed-size blocks with per-block prefix/suffix
minima, a doubling sparse table over the block minima, and an in-block
doubling table so every query — same-block or cross-block — is O(1) vector
gathers.

Memory: (3 + log2(block))·n + (n/block)·log(n/block) words.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax

INT32_INF = jnp.iinfo(jnp.int32).max


def block_size_for(s: int, cap: int = 128) -> int:
    """Largest power-of-two divisor of s, capped (host-side)."""
    b = s & (-s)  # lowest set bit = largest pow2 dividing s
    return min(b, cap)


@dataclasses.dataclass
class LocalRMQ:
    """Per-shard RMQ over a local (s,) int32 array."""

    x: jax.Array          # (s,)
    pref: jax.Array | None   # (s,) min over [block_start, i] (table mode only)
    suff: jax.Array | None   # (s,) min over [i, block_end) (table mode only)
    table: jax.Array      # (L, nb) sparse table over block minima; level 0 = block mins
    small: jax.Array | None  # (Lb, s) in-block doubling mins (optional)
    block: int

    @property
    def s(self) -> int:
        return self.x.shape[0]

    @property
    def nb(self) -> int:
        return self.table.shape[1]


def build_local_rmq(x, block: int | None = None,
                    with_small: bool = True) -> LocalRMQ:
    """``with_small=False`` builds only the block-min doubling table — right
    when the query count is small: the build is then a single O(s) min-reduce
    (no in-block tables, no per-block prefix/suffix scans), and queries
    answer their edge blocks with two masked block-row gathers."""
    s = x.shape[0]
    INF = jnp.iinfo(x.dtype).max
    block = block or block_size_for(s)
    nb = s // block
    xb = x.reshape(nb, block)
    if with_small:
        pref = lax.cummin(xb, axis=1).reshape(s)
        suff = lax.cummin(xb, axis=1, reverse=True).reshape(s)
    else:
        pref = suff = None
    levels = max(1, nb.bit_length())
    rows = [xb.min(axis=1)]
    for j in range(1, levels):
        prev = rows[-1]
        w = 1 << (j - 1)
        shifted = jnp.concatenate([prev[w:], jnp.full((min(w, nb),), INF, prev.dtype)])[:nb]
        rows.append(jnp.minimum(prev, shifted))
    # in-block doubling table: same-block queries become two O(1) gathers
    # (chosen over a (q, block) windowed gather on the previous target;
    # re-measured per ROADMAP C3)
    small = None
    if with_small:
        sm = [x]
        for j in range(1, max(1, block.bit_length())):
            prev = sm[-1]
            w = 1 << (j - 1)
            shifted = jnp.concatenate([prev[w:], jnp.full((min(w, s),), INF, prev.dtype)])[:s]
            sm.append(jnp.minimum(prev, shifted))
        small = jnp.stack(sm)
    return LocalRMQ(x=x, pref=pref, suff=suff, table=jnp.stack(rows),
                    small=small, block=block)


def _floor_log2(v):
    return (31 - lax.clz(jnp.maximum(v, 1).astype(jnp.int32))).astype(jnp.int32)


def query_local_rmq(rmq: LocalRMQ, lo, hi):
    """Vectorized min over inclusive local ranges [lo, hi], 0 <= lo <= hi < s.

    lo, hi: (q,) int32. Returns (q,) int32 minima.
    """
    block, nb = rmq.block, rmq.nb
    s = rmq.s
    INF = jnp.iinfo(rmq.x.dtype).max
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)
    bl = lo // block
    bh = hi // block
    # --- interior full blocks (bl, bh) exclusive, from the doubling table
    a = bl + 1
    b = bh - 1
    length = b - a + 1
    lev = _floor_log2(length)
    flat = rmq.table.reshape(-1)
    t1 = flat[jnp.clip(lev * nb + a, 0, flat.shape[0] - 1)]
    t2 = flat[jnp.clip(lev * nb + b - (1 << lev) + 1, 0, flat.shape[0] - 1)]
    mid = jnp.where(length > 0, jnp.minimum(t1, t2), INF)
    if rmq.small is not None:
        # --- same-block path: classic two-lookup doubling query
        length = hi - lo + 1
        slev = _floor_log2(length)
        sflat = rmq.small.reshape(-1)
        s1 = sflat[jnp.clip(slev * s + lo, 0, sflat.shape[0] - 1)]
        s2 = sflat[jnp.clip(slev * s + hi - (1 << slev) + 1, 0, sflat.shape[0] - 1)]
        same_min = jnp.minimum(s1, s2)
        cross_min = jnp.minimum(jnp.minimum(rmq.suff[lo], rmq.pref[hi]), mid)
        return jnp.where(bl == bh, same_min, cross_min)
    # --- few-queries mode: edge blocks via two masked block-row gathers
    # (row-aligned jnp.take instead of a vmapped dynamic_slice)
    xb = rmq.x.reshape(nb, block)
    lw = jnp.take(xb, bl, axis=0)  # (q, block)
    rw = jnp.take(xb, bh, axis=0)
    offs = jnp.arange(block, dtype=jnp.int32)[None, :]
    lo_off = (lo - bl * block)[:, None]
    hi_off = (hi - bh * block)[:, None]
    same = (bl == bh)[:, None]
    lmask = (offs >= lo_off) & (~same | (offs <= hi_off))
    rmask = (offs <= hi_off) & (~same | (offs >= lo_off))
    edge = jnp.minimum(
        jnp.min(jnp.where(lmask, lw, INF), axis=1),
        jnp.min(jnp.where(rmask, rw, INF), axis=1))
    return jnp.minimum(edge, mid)


# ---------------------------------------------------------------------------
# argmin-carrying variant (leftmost index of the minimum)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArgLocalRMQ:
    """Per-shard RMQ returning the *leftmost argmin* index — what tree
    walks need (the reference's ``rmq::query`` returns an iterator to the
    min element; the blind search relies on scanning children left to
    right, reference ``include/seq_query.hpp:471-501``).

    Layout: ONLY a (L, nb) doubling table over block minima — edge blocks
    are answered per query with two masked block-row gathers (`jnp.take`
    of contiguous rows). In-block doubling tables over the full (Lb, s)
    array trade those reads for random gathers into multi-hundred-MB
    tables (the choice was made on the previous target; ROADMAP C3)."""

    x: jax.Array
    tab_v: jax.Array   # (L, nb) block-min doubling table values
    tab_a: jax.Array   # (L, nb) leftmost argmin (global in-shard index)
    block: int

    @property
    def nb(self) -> int:
        return self.tab_v.shape[1]

    @property
    def s(self) -> int:
        return self.x.shape[0]


def _argmin_op(a, b):
    """Associative+commutative leftmost-min combine on (value, index) pairs:
    ties break on the smaller index, so operand order never matters (the
    reverse scan passes operands in flipped order)."""
    av, ai = a
    bv, bi = b
    take_b = (bv < av) | ((bv == av) & (bi < ai))
    return (jnp.where(take_b, bv, av), jnp.where(take_b, bi, ai))


def build_arg_rmq(x, block: int | None = None) -> ArgLocalRMQ:
    """O(s) build: one block-argmin reduce + a doubling table over the
    (s/block,) block minima."""
    s = x.shape[0]
    INF = jnp.iinfo(x.dtype).max
    block = block or block_size_for(s)
    nb = s // block
    xb = x.reshape(nb, block)
    rows_v = [xb.min(axis=1)]
    rows_a = [(jnp.arange(nb, dtype=jnp.int32) * block
               + jnp.argmin(xb, axis=1).astype(jnp.int32))]
    levels = max(1, nb.bit_length())
    for j in range(1, levels):
        w = 1 << (j - 1)
        pv, pa = rows_v[-1], rows_a[-1]
        if w >= nb:
            rows_v.append(pv)
            rows_a.append(pa)
            continue
        sv = jnp.concatenate([pv[w:], jnp.full((w,), INF, pv.dtype)])[:nb]
        sa_ = jnp.concatenate([pa[w:], jnp.zeros((w,), pa.dtype)])[:nb]
        v, a = _argmin_op((pv, pa), (sv, sa_))
        rows_v.append(v)
        rows_a.append(a)
    return ArgLocalRMQ(x=x, tab_v=jnp.stack(rows_v), tab_a=jnp.stack(rows_a),
                       block=block)


def query_arg_rmq(rmq: ArgLocalRMQ, lo, hi):
    """Leftmost argmin index over inclusive local ranges [lo, hi].

    lo, hi: (q,) int32 with 0 <= lo <= hi < s. Returns (q,) int32 indices.

    Edge blocks come from two masked block-row gathers; `jnp.argmin` over
    the masked window is leftmost by construction. Interior full blocks
    come from the small doubling table.
    """
    block, nb, s = rmq.block, rmq.nb, rmq.s
    INF = jnp.iinfo(rmq.x.dtype).max
    bl = lo // block
    bh = hi // block
    xb = rmq.x.reshape(nb, block)
    lw = jnp.take(xb, bl, axis=0)  # (q, block)
    rw = jnp.take(xb, bh, axis=0)
    offs = jnp.arange(block, dtype=jnp.int32)[None, :]
    lo_off = (lo - bl * block)[:, None]
    hi_off = (hi - bh * block)[:, None]
    same = (bl == bh)[:, None]
    lmask = (offs >= lo_off) & (~same | (offs <= hi_off))
    rmask = (offs <= hi_off) & (~same | (offs >= lo_off))
    lwm = jnp.where(lmask, lw, INF)
    rwm = jnp.where(rmask, rw, INF)
    l_off = jnp.argmin(lwm, axis=1).astype(jnp.int32)  # first min = leftmost
    r_off = jnp.argmin(rwm, axis=1).astype(jnp.int32)
    left = (jnp.min(lwm, axis=1), bl * block + l_off)
    right = (jnp.min(rwm, axis=1), bh * block + r_off)
    # interior full blocks (bl, bh) exclusive
    a = bl + 1
    b = bh - 1
    length = b - a + 1
    lev = _floor_log2(length)
    flat_v = rmq.tab_v.reshape(-1)
    flat_a = rmq.tab_a.reshape(-1)
    i1 = jnp.clip(lev * nb + a, 0, flat_v.shape[0] - 1)
    i2 = jnp.clip(lev * nb + b - (1 << lev) + 1, 0, flat_v.shape[0] - 1)
    t1 = (jnp.where(length > 0, flat_v[i1], INF), flat_a[i1])
    t2 = (jnp.where(length > 0, flat_v[i2], INF), flat_a[i2])
    cand = _argmin_op(left, t1)
    cand = _argmin_op(cand, t2)
    cand = _argmin_op(cand, right)
    return cand[1]
