"""Blocked vectorized per-element nearest-smaller-value engine.

A sequential run-stack scan answers ANSV in one O(s) pass, but as one
dependent scalar chain per side.  This engine instead answers the
per-element question "last j < i with x[j] < x[i]" with *vectorized block
compares*:

  1. all-pairs within each B-element block (and against the immediately
     preceding block) — O(s*B) fused compare/reduce work, no gathers;
  2. elements unresolved locally locate their target block via the
     two-level block/superblock minima (broadcast compares against rows
     shared by whole superblocks — no random gathers);
  3. only the (typically few) elements whose answer lies in a distant
     block pay a row gather, compacted by one 1-key sort and processed in
     capacity-bounded chunks.

The three reference match types (``include/ansv_common.hpp:20-25``) reduce
to two primitive arrays plus one grouped head table:

  * ``nearest_sm(i)``  = PSV(i)  = last j < i with x[j] <  x[i]
  * ``nearest_eq(i)``  = PSEV(i) = last j < i with x[j] <= x[i]
  * ``furthest_eq(i)`` = H[i] if H[i] != i else H[PSV(i)]

where ``H[t] = min{ u : x[u] == x[t] and PSV(u) == PSV(t) }`` is the head
of t's *visible equal run*: two equal-valued positions share a PSV exactly
when nothing smaller separates them, so grouping by ``(PSV, value)``
recovers the run structure the reference's stack scan maintains
(``include/ansv.hpp:47-93``); the run head is each group's minimum index
(one 3-key sort + a segmented broadcast).  Proof sketch for the
``furthest_eq`` identity: if an equal of x[i] is visible from i, i belongs
to that run and H[i] is its head; otherwise i heads its own run
(H[i] == i) and the match is the head of PSV(i)'s run.

Right-side matches are left-side matches of the reversed array (caller
flips).  Pure per-shard jnp (no collectives, no Pallas) — runs and is
tested on every backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM

B = 256
_BC = 512        # blocks per lax.map chunk in the all-pairs stage
_QDIV = 64       # cross-block resolve chunk = max(s // _QDIV, _QMIN)
_QMIN = 2048


def _cmp(a, b, strict: bool):
    return (a < b) if strict else (a <= b)


def _map_chunks(fn, arrays, rows_per_chunk: int):
    """lax.map ``fn`` over leading-axis chunks of equally-shaped arrays."""
    n = arrays[0].shape[0]
    if n <= rows_per_chunk:
        return fn(arrays)
    pad = (-n) % rows_per_chunk
    padded = []
    for a in arrays:
        if pad:
            fillrow = jnp.zeros((pad,) + a.shape[1:], a.dtype)
            a = jnp.concatenate([a, fillrow])
        padded.append(a.reshape(-1, rows_per_chunk, *a.shape[1:]))
    out = lax.map(fn, tuple(padded))
    return out.reshape(-1, *out.shape[2:])[:n]


def block_psv(x, strict: bool):
    """Per-element previous smaller (strict) / smaller-or-equal index.

    x: (s,) int array.  Returns (s,) int32 indices, -1 where no match.
    """
    s = x.shape[0]
    INF = jnp.iinfo(x.dtype).max
    nb0 = -(-s // B)
    pad0 = nb0 * B - s
    xf = jnp.concatenate([x, jnp.full((pad0,), INF, x.dtype)]) if pad0 else x
    x2 = xf.reshape(nb0, B)
    offs = jnp.arange(B, dtype=jnp.int32)

    # ---- stage 1: own-block + previous-block all-pairs --------------------
    xprev = jnp.concatenate([jnp.full((1, B), INF, x.dtype), x2[:-1]], axis=0)
    tri = offs[None, :] < offs[:, None]  # (i, j): j < i

    def allpairs(args):
        xc, xp = args  # (C, B) each
        q_own = _cmp(xc[:, None, :], xc[:, :, None], strict) & tri[None]
        own = jnp.max(jnp.where(q_own, offs[None, None, :], -1), axis=2)
        q_prev = _cmp(xp[:, None, :], xc[:, :, None], strict)
        prev = jnp.max(jnp.where(q_prev, offs[None, None, :], -1), axis=2)
        return jnp.stack([own, prev], axis=-1).astype(jnp.int32)

    both = _map_chunks(allpairs, (x2, xprev), _BC)  # (nb0, B, 2)
    own = both[..., 0].reshape(-1)
    prevb = both[..., 1].reshape(-1)

    b_of = (jnp.arange(nb0 * B, dtype=jnp.int32) // B)
    ans = jnp.where(own >= 0, b_of * B + own, -1)
    if nb0 == 1:
        return ans[:s]

    # ---- stage 2: target block via block/superblock minima ---------------
    m0 = x2.min(axis=1)  # (nb0,)
    nb1 = -(-nb0 // B)
    pad1 = nb1 * B - nb0
    m0f = jnp.concatenate([m0, jnp.full((pad1,), INF, m0.dtype)]) if pad1 else m0
    m1_2 = m0f.reshape(nb1, B)
    m1 = m1_2.min(axis=1)  # (nb1,)
    sb_offs = jnp.arange(nb1, dtype=jnp.int32)

    SB = B * B  # elements per superblock
    padE = nb1 * SB - nb0 * B
    vf = jnp.concatenate([xf, jnp.full((padE,), INF, x.dtype)]) if padE else xf
    v_sb = vf.reshape(nb1, SB)
    bb = (jnp.arange(SB, dtype=jnp.int32) // B)  # block index inside sb

    def per_superblock(args):
        v, m0row, g = args  # (SB,), (B,), scalar
        q1 = _cmp(m0row[None, :], v[:, None], strict) & \
            (offs[None, :] < bb[:, None])
        t1 = jnp.max(jnp.where(q1, offs[None, :], -1), axis=1)
        q2 = _cmp(m1[None, :], v[:, None], strict) & (sb_offs[None, :] < g)
        s2 = jnp.max(jnp.where(q2, sb_offs[None, :], -1), axis=1)
        row2 = jnp.take(m1_2, jnp.clip(s2, 0, nb1 - 1), axis=0)  # (SB, B)
        q3 = _cmp(row2, v[:, None], strict)
        t2 = jnp.max(jnp.where(q3, offs[None, :], 0), axis=1)
        tb = jnp.where(t1 >= 0, g * B + t1,
                       jnp.where(s2 >= 0, s2 * B + t2, -1))
        return tb.astype(jnp.int32)

    tb = lax.map(per_superblock,
                 (v_sb, m1_2, jnp.arange(nb1, dtype=jnp.int32))).reshape(-1)
    tb = tb[:nb0 * B]

    # prev-block pass already answered targets in block b-1
    ans = jnp.where((ans < 0) & (tb == b_of - 1) & (prevb >= 0),
                    (b_of - 1) * B + prevb, ans)

    # ---- stage 3: distant-block answers (compact -> chunked row gathers) --
    gidx = jnp.arange(nb0 * B, dtype=jnp.int32)
    unres = (ans < 0) & (tb >= 0) & (tb != b_of - 1) & (gidx < s)
    I32 = jnp.iinfo(jnp.int32).max
    key = jnp.where(unres, gidx, I32)
    ks, tbs, vs = lax.sort((key, tb, xf), num_keys=1)
    nq = jnp.sum(unres.astype(jnp.int32))
    S = nb0 * B
    m_pad = min(S, max(_QMIN, S // _QDIV))

    def cond(st):
        return st[0] * m_pad < nq

    def body(st):
        c, out_pad = st
        off = jnp.minimum(c * m_pad, S - m_pad)
        kc = lax.dynamic_slice_in_dim(ks, off, m_pad)
        tc = lax.dynamic_slice_in_dim(tbs, off, m_pad)
        vc = lax.dynamic_slice_in_dim(vs, off, m_pad)
        valid = kc != I32
        rows = jnp.take(x2, jnp.clip(tc, 0, nb0 - 1), axis=0)  # (m_pad, B)
        last = jnp.max(jnp.where(_cmp(rows, vc[:, None], strict),
                                 offs[None, :], 0), axis=1)
        ansc = tc * B + last
        row = jnp.where(valid, kc, S)
        # drop-slot buffer padded ONCE outside the loop (an in-body concat
        # re-copies the full array every chunk)
        out_pad = out_pad.at[row].set(jnp.where(valid, ansc, 0))
        return (c + 1, out_pad)

    ans_pad = jnp.concatenate([ans, jnp.zeros((1,), ans.dtype)])
    _, ans_pad = lax.while_loop(cond, body, (jnp.int32(0), ans_pad))
    return ans_pad[:s]


def _run_heads(x, psv):
    """H[t] = min index of t's (PSV, value) group (the visible-run head)."""
    s = x.shape[0]
    gidx = jnp.arange(s, dtype=jnp.int32)
    k1 = (psv + 1).astype(jnp.int32)  # [0, s]
    k1s, k2s, gs = lax.sort((k1, x, gidx), num_keys=3)
    prev1 = jnp.concatenate([jnp.full((1,), -1, k1s.dtype), k1s[:-1]])
    prev2 = jnp.concatenate([jnp.full((1,), -1, k2s.dtype)
                             .astype(k2s.dtype), k2s[:-1]])
    seg = (k1s != prev1) | (k2s != prev2)
    start_pos = lax.cummax(jnp.where(seg, gidx, -1))
    h_sorted = gs[jnp.maximum(start_pos, 0)]  # monotone gather
    # un-permute by sorting on gs (a permutation) instead of the equivalent
    # .at[gs].set inverse-permutation scatter (a lowering choice made on the
    # previous target; ROADMAP C3)
    return lax.sort((gs, h_sorted), num_keys=1)[1]


def nsv_left(x, typ: int):
    """Left matches of every element; returns (idx, val), idx -1 = none."""
    if typ == NEAREST_SM:
        idx = block_psv(x, strict=True)
    elif typ == NEAREST_EQ:
        idx = block_psv(x, strict=False)
    else:  # FURTHEST_EQ
        psv = block_psv(x, strict=True)
        H = _run_heads(x, psv)
        gidx = jnp.arange(x.shape[0], dtype=jnp.int32)
        h_psv = H[jnp.maximum(psv, 0)]
        idx = jnp.where(H != gidx, H, jnp.where(psv >= 0, h_psv, -1))
    val = x[jnp.maximum(idx, 0)]
    return idx, jnp.where(idx >= 0, val, jnp.zeros((), x.dtype))
