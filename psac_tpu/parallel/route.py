"""Capacity-padded all-to-all routing (the ragged-all2allv / bulk_rma replacement).

The reference routes irregular per-element messages with MPI's ragged
``all2allv`` (``include/bulk_rma.hpp:13-135``, ``mxx::all2all_func``).
SPMD/XLA requires static shapes, so routing here uses a *capacity-padded*
exchange: each shard buckets its m records by destination shard into a
(p, cap) buffer, performs one ``lax.all_to_all``, computes answers at the
owner, and reverses the exchange.

``cap`` is the per-destination send capacity.  The worst case is cap = m
(every record to one destination; the default), giving O(p*m) buffers — the
reference's all2allv moves O(m).  Callers with statistically balanced
destinations (bulk gathers by position, the tail / query paths) pass
cap ≈ a small multiple of m/p for O(m)-total buffers; records beyond a
destination's capacity are *dropped* (answers fill with zeros) and counted
in a psum'd overflow scalar, which ``with_overflow=True`` surfaces so the
host can retry the whole jitted call with a doubled capacity.

All functions run inside shard_map over the 1-D mesh axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from psac_tpu.parallel.mesh import AXIS

INT32_INF = jnp.iinfo(jnp.int32).max


def cap_for(m: int, p: int, capscale: int | None) -> int | None:
    """Per-destination send capacity for ~balanced destinations.

    ``capscale`` bounds the tolerated imbalance: capacity = capscale * ceil
    (m/p) + 64.  None (or capscale >= p) selects the worst-case cap = m
    (never overflows).  Callers retry with a larger scale on overflow.
    """
    if capscale is None or capscale >= p:
        return None
    return min(m, capscale * (-(-m // p)) + 64)


def _bucket_by_dest(dest, p: int, cap: int, skip=None):
    """Stable-bucket local records by destination shard.

    Returns (order, dropped mask, overflow mask, flat_pos): record
    ``order[t]`` (original index) goes to flat buffer position
    ``flat_pos[t] = dest_sorted[t]*cap + slot[t]``.  Records with ``skip``
    True are not routed at all (they sort last and take the drop slot p*cap
    without consuming capacity); records whose slot exceeds ``cap``
    overflow (dropped + counted).
    """
    m = dest.shape[0]
    dkey = dest if skip is None else jnp.where(skip, jnp.int32(p), dest)
    # explicit int32: under an x64 trace (packed-key builds) argsort would
    # default to int64 indices and double the permute bytes
    order = jnp.argsort(dkey, stable=True).astype(jnp.int32)
    dsort = dkey[order]
    # slot within the destination bucket = position - start of the run
    # (runs are contiguous in dsort; cummax of the run-start positions
    # instead of searchsorted, a lowering choice made on the previous
    # target — ROADMAP C3)
    i = jnp.arange(m, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), dsort[1:] != dsort[:-1]])
    start = lax.cummax(jnp.where(is_start, i, 0))
    slot = i - start
    skipped = dsort >= p
    ovf = (slot >= cap) & ~skipped
    dropped = ovf | skipped
    # the flat send-buffer index reaches p*cap, which exceeds int32 for
    # huge per-shard record counts (the 2^31-char int64 builds)
    fdt = jnp.int32 if p * cap < (1 << 31) else \
        jax.dtypes.canonicalize_dtype(jnp.int64)
    flat_pos = jnp.where(dropped, jnp.asarray(p * cap, fdt),
                         dsort.astype(fdt) * cap + slot)
    return order, dropped, ovf, flat_pos


def route_apply(payloads: tuple, dest, answer_fn, out_dtypes: tuple, p: int,
                cap: int | None = None, skip=None,
                with_overflow: bool = False):
    """Round-trip routing: ship records to ``dest`` shards, apply, return answers.

    Args:
      payloads: tuple of (m, ...) local arrays (the record fields; trailing
        dims are carried along, e.g. a (m, Lmax) pattern matrix).
      dest: (m,) destination shard of each record (int32, in [0, p)).
      answer_fn: fn(received_payloads: tuple of (p*cap, ...), valid:
        (p*cap,) bool) -> tuple of (p*cap, ...) answers, evaluated on the
        owner shard.
      out_dtypes: dtypes of the answers.
      cap: per-destination send capacity (default m = never overflows).
      skip: optional (m,) bool — records resolved locally; they are not
        routed, consume no capacity, and get zero answers.
      with_overflow: also return the psum'd count of overflowed records.
    Returns:
      tuple of (m, ...) answer arrays aligned with the original record order
      (skipped/overflowed records get zeros); plus the overflow count if
      requested.
    """
    m = dest.shape[0]
    if p == 1:
        # single shard: every record is already at its owner
        valid = jnp.ones((m,), jnp.bool_) if skip is None else ~skip
        outs = answer_fn(tuple(payloads), valid)
        if with_overflow:
            return outs, jnp.int32(0)
        return outs
    if cap is None and m > p:
        # full-capacity pass: route in p chunks of cap=chunk each (a chunk
        # cannot overflow its own size), bounding peak exchange buffers at
        # O(m + p*chunk) ~ O(m) instead of the one-shot cap=m pass's O(p*m)
        # (at 16M records x p=16 that one-shot pass is a ~1 GB-per-operand
        # spike)
        return _route_apply_chunked(payloads, dest, answer_fn, out_dtypes,
                                    p, skip, with_overflow)
    if cap is None:
        cap = m
    cap = min(cap, m)
    order, dropped, ovf, flat_pos = _bucket_by_dest(dest, p, cap, skip)
    buf_len = p * cap

    def to_buf(x, fill=0):
        shape = (buf_len + 1,) + x.shape[1:]
        return jnp.full(shape, fill, x.dtype).at[flat_pos].set(x[order])[:buf_len]

    def exchange(x):
        shaped = x.reshape((p, cap) + x.shape[1:])
        out = lax.all_to_all(shaped, AXIS, split_axis=0, concat_axis=0)
        return out.reshape((buf_len,) + x.shape[1:])

    sent = tuple(to_buf(x) for x in payloads)
    sent_valid = jnp.zeros((buf_len + 1,), jnp.bool_).at[flat_pos].set(
        True)[:buf_len]

    recv = tuple(exchange(x) for x in sent)
    recv_valid = exchange(sent_valid)

    answers = answer_fn(recv, recv_valid)
    assert isinstance(answers, tuple)

    back = tuple(exchange(a) for a in answers)

    # un-bucket: answer of original record order[t] sits at flat_pos[t]
    outs = []
    safe_pos = jnp.minimum(flat_pos, buf_len - 1)
    for a, dt in zip(back, out_dtypes):
        picked = a[safe_pos]  # aligned with sorted order
        mask = dropped if picked.ndim == 1 else dropped[:, None]
        picked = jnp.where(mask, jnp.zeros_like(picked), picked)
        outs.append(jnp.zeros((m,) + a.shape[1:], dt).at[order].set(picked))
    if with_overflow:
        novf = lax.psum(jnp.sum(ovf.astype(jnp.int32)), AXIS)
        return tuple(outs), novf
    return tuple(outs)


#: Diagnostics of the most recent chunked full-capacity pass (tests assert
#: the bounded buffer size): {"chunk": int, "buf_rows": int, "m": int}.
LAST_CHUNKED_ROUTE: dict = {}


def _route_apply_chunked(payloads: tuple, dest, answer_fn, out_dtypes: tuple,
                         p: int, skip, with_overflow: bool):
    """Never-overflowing routing as a ``lax.map`` over p record chunks, each
    exchanged at cap = chunk (a chunk's records cannot exceed its own size
    at any destination).  The reference's ragged ``all2allv`` moves O(m)
    total (``include/bulk_rma.hpp:112-135``); this matches that bound while
    keeping static shapes — at the price of p sequential exchanges instead
    of one."""
    m = dest.shape[0]
    chunk = -(-m // p)
    mp = chunk * p
    pad = mp - m

    def padx(x, fill=0):
        if pad == 0:
            return x
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])

    skip_all = jnp.zeros((m,), jnp.bool_) if skip is None else skip
    skip_p = jnp.concatenate(
        [skip_all, jnp.ones((pad,), jnp.bool_)]) if pad else skip_all

    def resh(x):
        return x.reshape((p, chunk) + x.shape[1:])

    def body(args):
        d_c, s_c = args[0], args[1]
        pl_c = tuple(args[2:])
        return route_apply(pl_c, d_c, answer_fn, out_dtypes, p, cap=chunk,
                           skip=s_c, with_overflow=False)

    outs = lax.map(body, (resh(padx(dest)), resh(skip_p))
                   + tuple(resh(padx(x)) for x in payloads))
    outs = tuple(o.reshape((mp,) + o.shape[2:])[:m] for o in outs)
    LAST_CHUNKED_ROUTE.update(chunk=chunk, buf_rows=p * chunk, m=m)
    if with_overflow:
        return outs, jnp.int32(0)
    return outs


def route_scatter(dest_idx, values: tuple, targets: tuple, valid, s: int, p: int,
                  combine: tuple | None = None, cap: int | None = None,
                  with_overflow: bool = False, width: int = 1, slots=None):
    """One-way scatter: targets[k][dest_idx[j] - shard_base] = values[k][j] at the owner.

    ``dest_idx`` are *global* element indices; records with ``valid`` False are
    dropped. ``combine`` selects per-target accumulation: "set" (default,
    last-writer), "min", or "max" (used by the GST's ``$``-edge leaf-range
    slots). ``cap``/``with_overflow`` as in ``route_apply``. Returns the
    updated target arrays (each (s,) local).

    With ``width > 1``, ``dest_idx`` are global *row* indices over N = s*p
    rows, ``slots`` (m,) holds each record's column in [0, width), and each
    target is a (s*width,) row-major local table; the write lands at
    (row - shard_base)*width + slot.  Routing by (row, slot) keeps every
    shipped quantity within the row-index dtype: the flat global index
    N*width (the reference's uint64-addressed node table,
    ``include/suffix_tree.hpp:479``) never materializes, so byte-alphabet
    suffix trees need no int64 promotion.  The local flat index is computed
    in int64 when ``s*width`` exceeds int32.
    """
    m = dest_idx.shape[0]
    safe_idx = jnp.where(valid, dest_idx, 0)
    combine = combine or ("set",) * len(targets)
    tgt_len = s * width
    # local flat-index dtype: wide tables index in int64 (x64 builds only)
    ldt = jnp.int32 if tgt_len < (1 << 31) else \
        jax.dtypes.canonicalize_dtype(jnp.int64)
    if slots is None:
        slots = jnp.zeros((m,), jnp.int32)

    def local_flat(row, slot):
        if width == 1:
            return row.astype(ldt)
        return row.astype(ldt) * width + slot.astype(ldt)

    if p == 1:
        # invalid records land on the drop slot tgt_len, so no old-value
        # reads.  NB: separate 1-D scatters instead of one multi-column row
        # scatter (a lowering choice made on the previous target; ROADMAP C3).
        loc = jnp.where(valid, local_flat(safe_idx, slots), tgt_len)
        outs = []
        for tgt, v, how in zip(targets, values, combine):
            padded = jnp.concatenate([tgt, jnp.zeros((1,), tgt.dtype)])
            if how == "set":
                padded = padded.at[loc].set(v)
            elif how == "min":
                padded = padded.at[loc].min(v)
            elif how == "max":
                padded = padded.at[loc].max(v)
            else:
                raise ValueError(how)
            outs.append(padded[:tgt_len])
        if with_overflow:
            return tuple(outs), jnp.int32(0)
        return tuple(outs)
    if cap is None:
        cap = m
    cap = min(cap, m)
    dest = (safe_idx // s).astype(jnp.int32)
    # invalid records are never routed (consume no capacity)
    order, dropped, ovf, flat_pos = _bucket_by_dest(dest, p, cap, skip=~valid)
    buf_len = p * cap

    def to_buf(x, fill=0):
        return jnp.full((buf_len + 1,), fill, x.dtype).at[flat_pos].set(
            x[order])[:buf_len]

    sent = (to_buf(safe_idx),) + tuple(to_buf(v) for v in values)
    if width > 1:
        sent += (to_buf(slots),)
    sent_valid = jnp.zeros((buf_len + 1,), jnp.bool_).at[flat_pos].set(
        valid[order])[:buf_len]

    recv = tuple(lax.all_to_all(x.reshape(p, cap), AXIS, split_axis=0, concat_axis=0).reshape(buf_len) for x in sent)
    recv_valid = lax.all_to_all(sent_valid.reshape(p, cap), AXIS, split_axis=0, concat_axis=0).reshape(buf_len)

    # int64 so shard_base can exceed 2^31 (stays int32 without x64)
    base = lax.axis_index(AXIS).astype(
        jax.dtypes.canonicalize_dtype(jnp.int64)) * s
    row = recv[0] - base
    loc = local_flat(row, recv[-1] if width > 1 else None)
    loc = jnp.where(recv_valid, loc, tgt_len)  # out-of-range drop slot
    vals_recv = recv[1:-1] if width > 1 else recv[1:]
    outs = []
    for tgt, v, how in zip(targets, vals_recv, combine):
        padded = jnp.concatenate([tgt, jnp.zeros((1,), tgt.dtype)])
        # invalid records land on the drop slot; no old-value reads needed
        if how == "set":
            padded = padded.at[loc].set(v)
        elif how == "min":
            padded = padded.at[loc].min(v)
        elif how == "max":
            padded = padded.at[loc].max(v)
        else:
            raise ValueError(how)
        outs.append(padded[:tgt_len])
    if with_overflow:
        novf = lax.psum(jnp.sum(ovf.astype(jnp.int32)), AXIS)
        return tuple(outs), novf
    return tuple(outs)
