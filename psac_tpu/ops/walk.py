"""Vectorized sparse-table "walk" primitives for nearest-value searches.

These answer, for a batch of q queries over a local (s,) int32 array,
questions of the form "largest j < start with x[j] < v" or "smallest
j >= start with x[j] <= v" in O(log s) vectorized steps — one gather into a
doubling min-table per step.  They are the vectorized replacement for the
reference's sequential stack scans inside ANSV
(reference ``include/ansv.hpp:292-405``) and for its succinct RMQ walks:
instead of a data-dependent stack, every element binary-searches the
doubling table in lockstep.

Pure per-shard compute (no collectives); usable inside or outside shard_map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INT32_INF = jnp.iinfo(jnp.int32).max


# ---------------------------------------------------------------------------
# Hierarchical-window walks (T-ary min tree + masked row gathers)
#
# The doubling-table walks above do O(log s) *random single-element* gathers
# per query.  The T-ary formulation replaces them with ~2·log_T(s) *row*
# gathers of T elements (row-aligned jnp.take is bandwidth-bound): ascend
# the min tree until an ancestor's row holds a qualifying sibling, then
# descend picking the last/first qualifying child, in O(s·T/(T-1)) memory
# instead of O(s log s).
# ---------------------------------------------------------------------------

_T = 128
_TBITS = 7
# queries are processed in lax.map chunks: each level's (q, T) gather
# window is live during a query batch, so unchunked 16M-query walks would
# hold ~7 x 8 GB of windows — far past HBM.  512K-row chunks bound the
# live windows at ~2 GB total while staying bandwidth-efficient.
_QCHUNK = 1 << 19


def _chunked_walk(fn, start, v):
    q = start.shape[0]
    if q <= _QCHUNK:
        return fn(start, v)
    pad = (-q) % _QCHUNK
    if pad:
        start = jnp.concatenate([start, jnp.zeros((pad,), start.dtype)])
        v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
    nc = start.shape[0] // _QCHUNK
    out = jax.lax.map(lambda t: fn(t[0], t[1]),
                      (start.reshape(nc, _QCHUNK), v.reshape(nc, _QCHUNK)))
    return out.reshape(-1)[:q]


def _rows(a):
    """Pad to a multiple of T and view as (rows, T)."""
    n = a.shape[0]
    pad = (-n) % _T
    if pad:
        a = jnp.concatenate([a, jnp.full((pad,), jnp.iinfo(a.dtype).max,
                                         a.dtype)])
    return a.reshape(-1, _T)


def build_levels(x):
    """T-ary min-tree levels: levels[k][j] = min over x[j*T^k : (j+1)*T^k].

    Returns a tuple of (rows, T)-shaped arrays, level 0 = the padded input;
    the last level has a single row.
    """
    levels = [_rows(x)]
    while levels[-1].shape[0] > 1:
        levels.append(_rows(levels[-1].min(axis=1)))
    return tuple(levels)


def _take_row(rows, r):
    return jnp.take(rows, jnp.clip(r, 0, rows.shape[0] - 1), axis=0)


def levels_prev_lt(levels, start, v, strict: bool = True):
    """Largest j < start with x[j] < v (strict) or <= v; -1 if none.

    Hierarchical-window equivalent of ``prev_lt``; start: (q,) in [0, s].
    """
    return _chunked_walk(
        lambda st, vv: _levels_prev_lt_impl(levels, st, vv, strict),
        start, v)


def _levels_prev_lt_impl(levels, start, v, strict):
    L = len(levels)
    offs = jnp.arange(_T, dtype=jnp.int32)[None, :]

    def lt(a, b):
        return (a < b[:, None]) if strict else (a <= b[:, None])

    p0 = jnp.maximum(start.astype(jnp.int32) - 1, 0)
    none0 = start <= 0

    # ---- ascent: find the lowest level whose ancestor row has a
    # qualifying entry left of (or at, for level 0) the own position
    hits, lasts, sibs = [], [], []
    own = p0
    for k in range(L):
        parent = own >> _TBITS
        row = _take_row(levels[k], parent)
        if k == 0:
            qual = lt(row, v) & (offs <= (own & (_T - 1))[:, None])
        else:
            qual = lt(row, v) & (offs < (own & (_T - 1))[:, None])
        hit = jnp.any(qual, axis=1)
        last = jnp.max(jnp.where(qual, offs, -1), axis=1)
        hits.append(hit)
        lasts.append(last)
        sibs.append(parent * _T + last)
        own = parent

    K = jnp.full_like(p0, L)
    for k in reversed(range(L)):
        K = jnp.where(hits[k], k, K)

    # ---- descent from the hit node down to level 0
    c = jnp.zeros_like(p0)
    for k in range(L - 1, 0, -1):
        ck = jnp.where(K == k, sibs[k], c)
        row = _take_row(levels[k - 1], ck)
        qual = lt(row, v)
        last = jnp.max(jnp.where(qual, offs, 0), axis=1)
        c = jnp.where(K >= k, ck * _T + last, c)

    ans = jnp.where(K == 0, sibs[0], c)
    return jnp.where(none0 | (K >= L), -1, ans)


def levels_next_leq(levels, start, v, strict: bool = False):
    """Smallest j >= start with x[j] <= v (or < v); s if none (s = true
    input length; padded entries are +inf and never qualify)."""
    return _chunked_walk(
        lambda st, vv: _levels_next_leq_impl(levels, st, vv, strict),
        start, v)


def _levels_next_leq_impl(levels, start, v, strict):
    L = len(levels)
    s = levels[0].shape[0] * _T  # padded length; padded tail never qualifies
    offs = jnp.arange(_T, dtype=jnp.int32)[None, :]

    def le(a, b):
        return (a < b[:, None]) if strict else (a <= b[:, None])

    p0 = jnp.clip(start.astype(jnp.int32), 0, s - 1)
    none0 = start.astype(jnp.int32) >= s

    hits, firsts, sibs = [], [], []
    own = p0
    for k in range(L):
        parent = own >> _TBITS
        row = _take_row(levels[k], parent)
        if k == 0:
            qual = le(row, v) & (offs >= (own & (_T - 1))[:, None])
        else:
            qual = le(row, v) & (offs > (own & (_T - 1))[:, None])
        hit = jnp.any(qual, axis=1)
        first = jnp.min(jnp.where(qual, offs, _T), axis=1)
        hits.append(hit)
        firsts.append(first)
        sibs.append(parent * _T + jnp.minimum(first, _T - 1))
        own = parent

    K = jnp.full_like(p0, L)
    for k in reversed(range(L)):
        K = jnp.where(hits[k], k, K)

    c = jnp.zeros_like(p0)
    for k in range(L - 1, 0, -1):
        ck = jnp.where(K == k, sibs[k], c)
        row = _take_row(levels[k - 1], ck)
        qual = le(row, v)
        first = jnp.min(jnp.where(qual, offs, _T - 1), axis=1)
        c = jnp.where(K >= k, ck * _T + first, c)

    ans = jnp.where(K == 0, sibs[0], c)
    return jnp.where(none0 | (K >= L), s, ans)
