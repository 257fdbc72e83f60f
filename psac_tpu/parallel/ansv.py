"""Distributed All-Nearest-Smaller-Values over a block-sharded array.

Mesh-native redesign of the reference's generalized ANSV
(``include/ansv.hpp:1304-1740``): instead of stack scans + lr_mins
exchanges with 5 comm-pairing policies, every element resolves its match
with

  1. a *local* sparse-table walk inside its shard (``psac_tpu.ops.walk``),
  2. a target-shard selection against the replicated per-shard minima
     (one ``all_gather`` of p scalars; the shard minima play the role of
     the reference's exchanged ``lr_mins`` prefix-minima sequences), and
  3. at most two capacity-padded all-to-all query round trips
     (``route_apply``) answered by owner-side walks.

Match-type semantics (nearest_sm / nearest_eq / furthest_eq) are specified
in ``psac_tpu.ops.ansv`` (the sequential oracle).  The right side is the
left side on the block-reversed array (one ppermute), so only the left
logic exists.

All ``*_local`` functions run inside ``jax.shard_map`` over the mesh axis.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM
from psac_tpu.ops.walk import (
    INT32_INF,
    build_levels as build_min_table,  # hierarchical T-ary windows
    levels_next_leq as next_leq,
    levels_prev_lt as prev_lt,
)
from psac_tpu.parallel.mesh import AXIS, block_sharding, make_mesh, mesh_key, num_shards, padded_size
from psac_tpu.parallel.route import cap_for, route_apply

NONSV = INT32_INF


def nonsv_for(dt):
    """No-match sentinel for an index/value dtype (one above any valid
    global index; the int32 value is the historical ``NONSV``)."""
    return jnp.iinfo(dt).max


def _shard_last_lt(sm, v, lim, strict: bool):
    """Largest shard t < lim with sm[t] < v (or <= v); -1 if none. v, lim: (q,)."""
    p = sm.shape[0]
    t = jnp.arange(p, dtype=jnp.int32)[None, :]
    cmp = (sm[None, :] < v[:, None]) if strict else (sm[None, :] <= v[:, None])
    ok = cmp & (t < lim[:, None])
    return jnp.max(jnp.where(ok, t, -1), axis=1)


def _shard_first_eq(sm, v, tlo, thi):
    """Smallest shard t with tlo < t < thi and sm[t] == v; p if none."""
    p = sm.shape[0]
    t = jnp.arange(p, dtype=jnp.int32)[None, :]
    ok = (sm[None, :] == v[:, None]) & (t > tlo[:, None]) & (t < thi[:, None])
    return jnp.min(jnp.where(ok, t, p), axis=1)


def _left_nearest(x, table, sm, s: int, p: int, strict: bool,
                  cap: int | None = None):
    """nearest_sm (strict) / nearest_eq left matches; returns
    (gidx, value, overflow-count).  Index/value dtype follows ``x`` (the
    reference's ``index_t``/``T`` templates, include/ansv.hpp:2042-2051)."""
    from psac_tpu.ops.bansv import block_psv

    idt = x.dtype
    inf = nonsv_for(idt)
    v = x
    r = lax.axis_index(AXIS).astype(jnp.int32)
    base = (lax.axis_index(AXIS).astype(idt) * s).astype(idt)
    r_vec = jnp.full((s,), r, jnp.int32)

    # full-width per-element local matches run on the block engine (the
    # walks stay for the small routed-query answers below)
    jl = block_psv(v, strict=strict)
    found = jl >= 0
    C = _shard_last_lt(sm, v, r_vec, strict)
    skip = found | (C < 0)
    dest = jnp.clip(C, 0, p - 1)

    def answer(recv, recv_valid):
        (qv,) = recv
        j = prev_lt(table, jnp.full_like(qv, s, dtype=jnp.int32), qv,
                    strict=strict)
        ok = recv_valid & (j >= 0)
        val = x[jnp.maximum(j, 0)]
        return (jnp.where(ok, base + j, inf).astype(idt),
                jnp.where(ok, val, 0).astype(idt))

    (ridx, rval), ovf = route_apply((v,), dest, answer,
                                    (idt, idt), p, cap=cap,
                                    skip=skip, with_overflow=True)
    idx = jnp.where(found, base + jl, jnp.where(C >= 0, ridx, inf)).astype(idt)
    val = jnp.where(found, x[jnp.maximum(jl, 0)],
                    jnp.where(C >= 0, rval, 0)).astype(idt)
    return idx, val, ovf


def _left_furthest_eq(x, table, sm, s: int, p: int,
                      cap: int | None = None):
    """furthest_eq left matches; returns (gidx, value, overflow-count).

    Three-stage resolution: (a) nearest strictly-smaller j* (local walk or
    round-1 route; the owner also reports the leftmost *visible* occurrence
    ``e_home`` of the matched run inside its shard and whether the run may
    extend past the shard's left edge), (b) leftmost visible equal of the
    query value between j* and i (local walk + shard-minima selection),
    (c) if no equal exists, the leftmost visible member of j*'s run
    (round-2 route when it extends into an earlier shard).
    """
    from psac_tpu.ops.bansv import block_psv

    idt = x.dtype
    inf = nonsv_for(idt)
    v = x
    i_loc = jnp.arange(s, dtype=jnp.int32)
    r = lax.axis_index(AXIS).astype(jnp.int32)
    base = (lax.axis_index(AXIS).astype(idt) * s).astype(idt)
    r_vec = jnp.full((s,), r, jnp.int32)

    jstar = block_psv(v, strict=True)  # full-width local nearest-smaller
    has_loc = jstar >= 0
    C = _shard_last_lt(sm, v, r_vec, strict=True)
    has_rem = (~has_loc) & (C >= 0)
    dest1 = jnp.clip(C, 0, p - 1)

    def answer1(recv, recv_valid):
        (qv,) = recv
        j = prev_lt(table, jnp.full_like(qv, s, dtype=jnp.int32), qv,
                    strict=True)
        jsafe = jnp.maximum(j, 0)
        v2 = x[jsafe]
        # leftmost visible member of j*'s run inside this shard, and whether
        # the run reaches the shard's left edge (may extend further left)
        j0 = prev_lt(table, jsafe + 1, v2, strict=True) + 1
        e_home = next_leq(table, j0, v2)
        # leftmost occurrence of the *query* value after j* (all elements in
        # (j*, i) are >= qv, so the first <= qv is an equal and is visible)
        e_after = next_leq(table, jsafe + 1, qv)
        return ((base + j).astype(idt), v2,
                (base + jnp.minimum(e_home, s - 1)).astype(idt),
                (j0 == 0).astype(jnp.int32),
                (base + jnp.minimum(e_after, s - 1)).astype(idt),
                (e_after < s).astype(jnp.int32))

    (g1, v2_1, eh1, ext1, ea1, ea1_ok), ovf1 = route_apply(
        (v,), dest1, answer1, (idt, idt, idt, jnp.int32, idt, jnp.int32),
        p, cap=cap, skip=~has_rem, with_overflow=True)

    # same run info computed locally for elements whose j* is in-shard
    jsafe = jnp.maximum(jstar, 0)
    v2_l = x[jsafe]
    j0_l = prev_lt(table, jsafe + 1, v2_l, strict=True) + 1
    eh_l = next_leq(table, j0_l, v2_l)

    has_star = has_loc | has_rem
    gstar = jnp.where(has_loc, base + jstar, g1).astype(idt)
    v2 = jnp.where(has_loc, v2_l, v2_1).astype(idt)
    e_home = jnp.where(has_loc, base + jnp.minimum(eh_l, s - 1),
                       eh1).astype(idt)
    extend = jnp.where(has_loc, j0_l == 0, ext1 != 0)
    shard_g = jnp.where(has_star, (gstar // s).astype(jnp.int32), -1)
    # equal of v in shard(j*)'s suffix after a *remote* j*
    e_after_ok = has_rem & (ea1_ok != 0)

    # (b) leftmost equal of v in (j*, i): shard(j*) suffix (e_after), then
    # whole shards strictly between (t_eq: any equal there is visible since
    # every such shard has min >= v and one with min > v contains no equal),
    # then the own-shard prefix (e_loc)
    startpos = jnp.where(has_loc, jstar + 1, 0)
    e_loc = next_leq(table, startpos, v)
    e_loc_ok = e_loc < i_loc
    t_eq = _shard_first_eq(sm, v, shard_g, r_vec)
    t_eq_ok = t_eq < p

    # (c) no equal of v anywhere: the match is the leftmost visible member
    # of j*'s run.  It can sit in an earlier shard: either in t2 (smallest
    # shard with min == v2 between the blocker C2 and shard(j*)) or in the
    # suffix of the blocking shard C2 itself (after C2's last element < v2).
    no_eq = ~(e_after_ok | t_eq_ok | e_loc_ok)
    want_ext = no_eq & has_star & extend
    C2 = _shard_last_lt(sm, v2, shard_g, strict=True)
    t2 = _shard_first_eq(sm, v2, C2, shard_g)
    want_c2 = want_ext & (C2 >= 0)
    want_t2 = want_ext & (t2 < p)

    # round 2, query A: equal-of-v shard (t_eq) or blocker-suffix (C2)
    qval_a = jnp.where(t_eq_ok, v, v2)
    skip_a = ~(t_eq_ok | want_c2)
    dest_a = jnp.clip(jnp.where(t_eq_ok, t_eq, C2), 0, p - 1)
    # round 2, query B: run-continuation shard t2
    skip_b = ~want_t2
    dest_b = jnp.clip(t2, 0, p - 1)

    def answer2(recv, recv_valid):
        # leftmost occurrence of qv after this shard's last element < qv
        # (= the leftmost visible occurrence of qv; j0 == 0 when min == qv)
        (qv,) = recv
        j0 = prev_lt(table, jnp.full_like(qv, s, dtype=jnp.int32), qv,
                     strict=True) + 1
        e = next_leq(table, j0, qv)
        return ((base + jnp.minimum(e, s - 1)).astype(idt),
                (e < s).astype(jnp.int32))

    (e_a, e_a_ok), ovf2 = route_apply((qval_a,), dest_a, answer2,
                                      (idt, jnp.int32), p, cap=cap,
                                      skip=skip_a, with_overflow=True)
    (e_b, _), ovf3 = route_apply((v2,), dest_b, answer2, (idt, jnp.int32), p,
                                 cap=cap, skip=skip_b, with_overflow=True)

    ext_idx = jnp.where(want_c2 & (e_a_ok != 0), e_a,
                        jnp.where(want_t2, e_b, e_home))
    idx = jnp.where(
        e_after_ok, ea1,
        jnp.where(t_eq_ok, e_a,
                  jnp.where(e_loc_ok, base + e_loc,
                            jnp.where(has_star, jnp.where(extend, ext_idx, e_home),
                                      inf)))).astype(idt)
    val = jnp.where(e_after_ok | t_eq_ok | e_loc_ok, v,
                    jnp.where(has_star, v2, 0)).astype(idt)
    return idx, val, ovf1 + ovf2 + ovf3


def _left_match_local_only(x, s: int, typ: int):
    """Walk-based local-only matches (single-shard semantics); index/value
    dtype follows ``x``."""
    idt = x.dtype
    inf = nonsv_for(idt)
    table = build_min_table(x)
    i_loc = jnp.arange(s, dtype=jnp.int32)
    v = x
    if typ != FURTHEST_EQ:
        jl = prev_lt(table, i_loc, v, strict=(typ == NEAREST_SM))
        found = jl >= 0
        return (jnp.where(found, jl, inf).astype(idt),
                jnp.where(found, x[jnp.maximum(jl, 0)], 0).astype(idt))
    jstar = prev_lt(table, i_loc, v, strict=True)
    e_loc = next_leq(table, jstar + 1, v)
    has_eq = e_loc < i_loc
    jsafe = jnp.maximum(jstar, 0)
    v2 = x[jsafe]
    j0 = prev_lt(table, jsafe + 1, v2, strict=True) + 1
    eh = jnp.minimum(next_leq(table, j0, v2), s - 1)
    idx = jnp.where(has_eq, e_loc,
                    jnp.where(jstar >= 0, eh, inf)).astype(idt)
    val = jnp.where(has_eq, v, jnp.where(jstar >= 0, v2, 0)).astype(idt)
    return idx, jnp.where(idx == inf, 0, val).astype(idt)


#: single-shard ANSV engines selectable through ``PSAC_NSV``
ENGINES = ("block", "walk")


def _engine() -> str:
    """Single-shard ANSV engine selection (``PSAC_NSV`` env):

    - ``block`` (default): the blocked vectorized engine
      (``psac_tpu.ops.bansv``) for every match type — sorts, scans and
      gathers that XLA lowers on any backend; ``furthest_eq`` also builds a
      (PSV, value)-group head table.
    - ``walk``: the hierarchical-window walks (the engine the multi-shard
      pipeline answers its routed queries with).

    Multi-shard meshes always run the routed walk pipeline.
    """
    eng = os.environ.get("PSAC_NSV") or "block"
    if eng not in ENGINES:
        raise ValueError(f"PSAC_NSV must be one of {ENGINES}: {eng!r}")
    return eng


def _left_match_p1(x, s: int, typ: int):
    """Single-shard one-side matches on the selected engine."""
    if _engine() == "walk":
        return _left_match_local_only(x, s, typ)
    from psac_tpu.ops.bansv import nsv_left

    idt = x.dtype
    idx, val = nsv_left(x, typ)
    return (jnp.where(idx < 0, nonsv_for(idt), idx.astype(idt)),
            val.astype(idt))


def _left_match(x, s: int, p: int, typ: int, cap: int | None = None):
    if p == 1:
        idx, val = _left_match_p1(x, s, typ)
        return idx, val, jnp.int32(0)
    table = build_min_table(x)
    sm = lax.all_gather(jnp.min(x), AXIS)
    if typ == FURTHEST_EQ:
        return _left_furthest_eq(x, table, sm, s, p, cap=cap)
    return _left_nearest(x, table, sm, s, p, strict=(typ == NEAREST_SM),
                         cap=cap)


def _reverse_dist(x, p: int):
    """Reverse a block-distributed array (local reverse + shard-order flip)."""
    rev = x[::-1]
    if p == 1:
        return rev
    return lax.ppermute(rev, AXIS, [(i, p - 1 - i) for i in range(p)])


def ansv_local(x_l, s: int, p: int, left_type: int, right_type: int,
               capscale: int | None = None):
    """Distributed ANSV inside shard_map.

    Returns (lidx, lval, ridx, rval, ovf): global match indices (NONSV when
    no match), the array values at the matches, and the psum'd count of
    routing-capacity overflows (``capscale`` bounds the per-destination
    routing buffers via ``route.cap_for``; nonzero ovf means the caller must
    retry with a larger capscale — results are incomplete).
    """
    cap = cap_for(s, p, capscale)
    lidx, lval, ovf_l = _left_match(x_l, s, p, left_type, cap=cap)
    xr = _reverse_dist(x_l, p)
    ridx_r, rval_r, ovf_r = _left_match(xr, s, p, right_type, cap=cap)
    ovf = ovf_l + ovf_r
    ridx_r = _reverse_dist(ridx_r, p)
    rval = _reverse_dist(rval_r, p)
    N = s * p
    inf = nonsv_for(x_l.dtype)
    ridx = jnp.where(ridx_r == inf, inf,
                     jnp.asarray(N - 1, x_l.dtype) - ridx_r)
    return lidx, lval, ridx, rval, ovf


_JIT_CACHE: dict = {}


def ansv(arr, left_type: int = NEAREST_SM, right_type: int = NEAREST_SM,
         mesh=None, nonsv: int | None = None, indexing: str = "global"):
    """Distributed ANSV of a host array.

    Public equivalent of the reference's ``ansv<T, left, right, indexing>``
    (``include/ansv.hpp:2042-2051``; indexing types
    ``include/ansv_common.hpp:20-25``).  ``nonsv`` defaults to n (one past
    the end), mirroring the caller-chosen sentinel of the reference.
    Values that do not fit int32 run the same distributed pipeline at int64
    under a scoped x64 context (the reference's ``T`` template).

    - ``indexing="global"``: returns (left, right) np.int64 global indices.
    - ``indexing="local"``: returns (left, right) where each side is a
      (rank, local_idx, value) triple of np.int64 arrays — the owner shard,
      the index within it, and the matched value.  This is the reference's
      ``local_indexing`` capability (read the match position AND value with
      no further communication: in-shard matches index the local array,
      remote ones carry their value like the reference's received
      ``lr_mins`` entries); unmatched elements get rank = -1,
      local_idx = ``nonsv``, value = 0.
    """
    from psac_tpu.models.suffix_array import _x64_ctx

    vals = np.asarray(arr)
    i32 = np.iinfo(np.int32)
    wide = bool(vals.size) and (int(vals.min()) < i32.min
                                or int(vals.max()) >= i32.max)
    dt = np.int64 if wide else np.int32
    infd = np.iinfo(dt).max  # doubles as the +inf padding sentinel
    mesh = mesh or make_mesh()
    p = num_shards(mesh)
    n = len(arr)
    N = padded_size(max(n, 1), p)
    xp = np.full(N, infd, dt)
    xp[:n] = vals.astype(dt)

    s = N // p
    with _x64_ctx(dt):
        xs = jax.device_put(xp, block_sharding(mesh))
        for capscale in (4, None):
            key = (mesh_key(mesh), N, left_type, right_type, capscale,
                   np.dtype(dt).name, _engine())
            if key not in _JIT_CACHE:
                fn = jax.shard_map(
                    functools.partial(ansv_local, s=s, p=p,
                                      left_type=left_type,
                                      right_type=right_type,
                                      capscale=capscale),
                    mesh=mesh, in_specs=(P(AXIS),),
                    out_specs=(P(AXIS),) * 4 + (P(),))
                _JIT_CACHE[key] = jax.jit(fn)
            lidx, lval, ridx, rval, ovf = _JIT_CACHE[key](xs)
            if capscale is None or int(ovf) == 0:
                break
        lidx, lval, ridx, rval = jax.device_get((lidx, lval, ridx, rval))
    sent = n if nonsv is None else nonsv
    left = np.asarray(lidx)[:n].astype(np.int64)
    right = np.asarray(ridx)[:n].astype(np.int64)
    lmiss = left == infd
    # a right match pointing into the +inf padding means "no match"
    rmiss = (right == infd) | (right >= n)
    left[lmiss] = sent
    right[rmiss] = sent
    if indexing == "global":
        return left, right
    if indexing != "local":
        raise ValueError(f"indexing must be 'global' or 'local': {indexing}")
    lv = np.asarray(jax.device_get(lval))[:n].astype(np.int64)
    rv = np.asarray(jax.device_get(rval))[:n].astype(np.int64)
    lv[lmiss] = 0
    rv[rmiss] = 0

    def to_local(g, miss):
        rank = np.where(miss, -1, g // s)
        loc = np.where(miss, sent, g % s)
        return rank, loc

    lrank, lloc = to_local(left, lmiss)
    rrank, rloc = to_local(right, rmiss)
    return (lrank, lloc, lv), (rrank, rloc, rv)
