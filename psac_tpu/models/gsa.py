"""Generalized suffix array (+LCP) over string sets.

Mesh-native redesign of the reference's ``suffix_array::construct_ss``
(``include/suffix_array.hpp:269-363``) and the ``gsac`` tool
(``src/gsac.cpp``): all suffixes of all strings sorted together, each suffix
ending at its own string's end (virtual ``$`` = 0 terminator), indices into
the separator-removed concatenation (``src/gsac.cpp:58-84`` defines this
output convention); equal suffixes of different strings tie in stable
position order.

Where the reference builds dist_seqs/split-bucket machinery with
string-local shifts (``shift_buckets_ds``, ``include/shifting.hpp:374-418``)
and GSA-specific rebucketing (``rebucket_gsa``, ``include/bucketing.hpp:131``),
the flat formulation needs only one extra block-sharded array
``eos[i]`` = one-past-the-end of the string containing position i:

  * doubling shift:   B2 = where(i + d < eos[i], ISA[i + d], 0)
  * initial k-mers:   chars zero-masked past eos (window stays flat)
  * initial LCP:      bitwise k-mer LCP capped by both suffixes' remaining
                      lengths (the reference discounts ``$``-padding with
                      trailing_zeros, ``suffix_array.hpp:1404-1441``)
  * termination:      an element is settled when its (B, B2) pair is unique
                      OR B2 == 0 — groups of identical whole suffixes can
                      never split and are final (stable tie order)
  * final LCP ties:   rows still carrying the sentinel after the loop are
                      ties of identical suffixes; their LCP is the full
                      suffix length (fixed in one host pass).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from psac_tpu import config as cfg_mod
from psac_tpu.models.suffix_array import _Builder, _pow2ceil
from psac_tpu.ops.alphabet import Alphabet
from psac_tpu.ops.bitops import lcp_bitwise_words
from psac_tpu.parallel.collectives import (
    global_index_base,
    global_shift_left,
    halo_from_left,
    halo_from_right,
)
from psac_tpu.parallel.mesh import AXIS, make_mesh, mesh_key, num_shards
from psac_tpu.parallel.sort import dist_sort_local


@dataclasses.dataclass
class GeneralizedSuffixArray:
    """GSA over a string set: positions index the separator-removed flat text."""

    sa: np.ndarray
    lcp: np.ndarray | None
    alphabet: Alphabet
    lens: np.ndarray      # per-string lengths
    n: int

    @property
    def nstrings(self) -> int:
        return len(self.lens)


@dataclasses.dataclass
class DeviceGSA:
    """Device-resident GSA: (N,) padded block-sharded arrays (real rows are
    the trailing n, as in ``DeviceSuffixArray``) plus the eos array and the
    encoded flat text — the inputs the generalized suffix tree needs."""

    sa: jax.Array
    lcp: jax.Array | None
    eos: jax.Array
    xs: jax.Array
    alphabet: Alphabet
    lens: np.ndarray
    n: int
    N: int
    mesh: object

    def materialize(self) -> GeneralizedSuffixArray:
        off = self.N - self.n
        # np.array(copy): device_get of an int64 array returns a read-only
        # view, and the lcp_np[0] fixup below writes
        sa_np = np.array(jax.device_get(self.sa), np.int64)[off:]
        lcp_np = None
        if self.lcp is not None:
            lcp_np = np.array(jax.device_get(self.lcp), np.int64)[off:]
            if self.n > 0:
                lcp_np[0] = 0
        return GeneralizedSuffixArray(sa=sa_np, lcp=lcp_np,
                                      alphabet=self.alphabet,
                                      lens=self.lens, n=self.n)


class _GsaBuilder(_Builder):
    """Doubling builder threaded with the per-position eos array."""

    gsa_mode = True  # eos-aware sparse tail (reference construct_msgs_gsa)

    def __init__(self, mesh, N, ks, bits, with_lcp, idt=jnp.int32):
        super().__init__(mesh, N, ks, bits, with_lcp, idt=idt)
        shmap = functools.partial(jax.shard_map, mesh=mesh)
        x, r = P(AXIS), P()
        self._init = jax.jit(shmap(
            self._ginit_local,
            in_specs=(x, x),
            out_specs=(x, x) + ((x,) if with_lcp else ()) + (x, x, x)
                      + (r, r)))

    # ---------------- init: masked k-mer ranking ----------------

    def _ginit_local(self, codes_l, eos_l):
        s, p, N = self.s, self.p, self.N
        ks, bits = self.ks, self.bits
        idt = self.idt
        halo = halo_from_right(codes_l, sum(ks) - 1, p)
        win = jnp.concatenate([codes_l, halo])
        gidx = (global_index_base(s) + jnp.arange(s, dtype=jnp.int32)).astype(idt)
        words = []
        off = 0
        for kw in ks:
            w = jnp.zeros((s,), jnp.int32)
            for j in range(off, off + kw):
                c = jnp.where(gidx + j < eos_l, win[j:j + s], 0)
                w = (w << bits) | c
            words.append(w)
            off += kw
        rem = eos_l - gidx
        # padding rows (word0 == 0: only all-past-end windows; real suffixes
        # start with a char >= 1): unique final ranks before all real rows.
        # pad_rank stays int32 (rows sit within k of the global end, see
        # _init_local)
        pad_rank = (jnp.asarray(N, idt) - gidx).astype(jnp.int32)
        words[-1] = jnp.where(words[0] == 0, pad_rank, words[-1])
        sorted_ops = dist_sort_local(tuple(words) + (gidx, rem),
                                     num_keys=len(words) + 1, p=p)
        sa, rem_s = sorted_ops[-2], sorted_ops[-1]
        wsort = sorted_ops[:-2]
        prevs = tuple(
            jnp.concatenate([halo_from_left(w, 1, p, fill=-1), w[:-1]])
            for w in wsort)
        pr = halo_from_left(rem_s, 1, p, fill=0)
        prev_rem = jnp.concatenate([pr, rem_s[:-1]])
        newb = functools.reduce(
            jnp.logical_or, (w != pw for w, pw in zip(wsort, prevs)))
        isa_new, b_new, active, counts = self._rebucket_and_isa(newb, gidx, sa)
        # row-aligned end-of-string bound for direct tail entry
        eos_row = sa + rem_s
        outs = (isa_new, sa)
        if self.with_lcp:
            lcpv = lcp_bitwise_words(prevs, wsort, ks, bits)
            lcpv = jnp.minimum(jnp.minimum(lcpv.astype(idt), prev_rem), rem_s)
            lcp0 = jnp.where(newb, lcpv, jnp.asarray(N, idt))
            lcp0 = jnp.where(gidx == 0, jnp.asarray(0, idt), lcp0)
            outs = outs + (lcp0,)
        return outs + (b_new, active, eos_row) + counts

    # ---------------- one doubling iteration ----------------

    def step(self, q: int):
        if q not in self._step_cache:
            x, r = P(AXIS), P()
            lcp_outs = (x, x, x, x, r) if self.with_lcp else ()
            fn = jax.shard_map(
                functools.partial(self._gstep_local, q=q),
                mesh=self.mesh,
                in_specs=(x, x) + ((x,) if self.with_lcp else ()) + (r,),
                out_specs=(x, x) + lcp_outs + (x, x, x) + (r, r))
            self._step_cache[q] = jax.jit(fn)
        return self._step_cache[q]

    def _gstep_local(self, isa_l, eos_l, *rest, q):
        s, p, N = self.s, self.p, self.N
        idt = self.idt
        if self.with_lcp:
            lcp_l, d = rest
        else:
            (d,) = rest
        gidx = (global_index_base(s) + jnp.arange(s, dtype=jnp.int32)).astype(idt)
        b2 = self._shift(isa_l, d, q)
        b2 = jnp.where(gidx + d < eos_l, b2, jnp.asarray(0, idt))
        b_s, b2_s, sa, eos_s = dist_sort_local((isa_l, b2, gidx, eos_l),
                                               num_keys=3, p=p)
        pb = jnp.concatenate([halo_from_left(b_s, 1, p, fill=-1), b_s[:-1]])
        pb2 = jnp.concatenate([halo_from_left(b2_s, 1, p, fill=-1), b2_s[:-1]])
        newb = (b_s != pb) | (b2_s != pb2)
        isa_new, b_new, _, _ = self._rebucket_and_isa(newb, gidx, sa)
        # GSA termination: settled = unique (B, B2) pair or fully-ended
        # suffix group (B2 == 0 ties can never split; their order is final)
        nxt_halo = halo_from_right(newb, 1, p, fill=True)
        nxt = jnp.concatenate([newb[1:], nxt_halo])
        settled = (newb & nxt) | (b2_s == 0)
        active = ~settled
        ue = lax.psum(jnp.sum(active.astype(idt)), AXIS)
        counts = (ue, ue)
        if not self.with_lcp:
            return (isa_new, sa) + (b_new, active, eos_s) + counts
        split = (b_s == pb) & (b2_s != pb2)
        zerocase = split & ((pb2 == 0) | (b2_s == 0))
        lcp_l = jnp.where(zerocase & (lcp_l == N), d.astype(idt), lcp_l)
        querycase = split & (pb2 != 0) & (b2_s != 0)
        lq = jnp.minimum(pb2, b2_s)
        rq = jnp.maximum(pb2, b2_s) - 1
        nq = lax.psum(jnp.sum(querycase.astype(idt)), AXIS)
        qkey = jnp.where(querycase, gidx, self.INF)
        return (isa_new, sa, lcp_l, qkey, lq, rq, nq) + (b_new, active, eos_s) + counts


    # ------------- fully fused GSA construction (any shard count) ----------

    def gfused_full(self, m_cap: int, m_cap2: int, resolve_div: int = 32):
        key = ("gfused_full", m_cap, m_cap2, resolve_div)
        if key not in self._step_cache:
            x, r = P(AXIS), P()
            nout = 5 if self.with_lcp else 4
            fn = jax.shard_map(
                functools.partial(self._gfused_full_local, m_cap=m_cap,
                                  m_cap2=m_cap2, resolve_div=resolve_div),
                mesh=self.mesh, in_specs=(x, x),
                out_specs=(x,) * nout + (r,))
            self._step_cache[key] = jax.jit(fn)
        return self._step_cache[key]

    def _gfused_full_local(self, codes_l, eos_l, *, m_cap: int, m_cap2: int,
                           resolve_div: int = 32):
        """One dispatch: masked k-mer init -> dense eos-masked doubling
        (shared ``_fused_drive`` while_loop, traced d) -> eos-aware
        two-stage sparse tail -> sentinel-LCP tiefix.  The tiefix rides the
        same dispatch (a separate jitted call costs one extra host round
        trip plus an unfused 16M gather); its routing-overflow count is
        appended to ``stats`` so the caller can re-run the standalone fix
        with full capacity in the (p > 1 only) overflow case."""
        idt = self.idt
        m_pad = max(8, self.s // resolve_div)
        outs = self._ginit_local(codes_l, eos_l)
        if self.with_lcp:
            isa, sa, lcp, brow, active, eos_row, ub, ue = outs
        else:
            isa, sa, brow, active, eos_row, ub, ue = outs
            lcp = None

        def dense_step(isa, lcp, extra, d):
            if self.with_lcp:
                isa, sa, lcp, qkey, lq, rq, _nq, brow, active, eos_row, \
                    ub, ue = self._gstep_local(isa, eos_l, lcp, d, q=None)
                jcol = jnp.ones(qkey.shape, idt)
                lcp = self._resolve_fused_local(lcp, qkey, lq, rq, jcol, d,
                                                m_pad=m_pad, L=2)
            else:
                isa, sa, brow, active, eos_row, ub, ue = \
                    self._gstep_local(isa, eos_l, d, q=None)
            return isa, sa, lcp, brow, active, (eos_row,), ub, ue, d * 2

        fouts = self._fused_drive(
            (isa, sa, lcp, brow, active, (eos_row,), ub, ue),
            dense_step, m_cap=m_cap, m_cap2=m_cap2)
        if not self.with_lcp:
            return fouts[:-1] + (
                jnp.concatenate([fouts[-1], jnp.zeros((1,), idt)]),)
        isa, sa, lcp, brow, active, stats = fouts
        lcp, tovf = _lcp_tiefix_local(lcp, sa, eos_l, s=self.s, p=self.p,
                                      N=self.N, capscale=6)
        stats = jnp.concatenate([stats, tovf.astype(idt)[None]])
        return isa, sa, lcp, brow, active, stats


_GSA_BUILDER_CACHE: dict = {}
_GSA_INPUT_CACHE: dict = {}


def _gsa_inputs_fn(mesh, N: int, M: int, p: int, idt=jnp.int32):
    """Jitted device-side input prep: decode codes from raw bytes and expand
    the block-sharded per-position ``eos`` from the (M,) replicated string
    boundary arrays (string ends are increasing, so a scatter of end markers
    at each start position + a global cummax yields eos)."""
    key = (mesh_key(mesh), N, M, jnp.dtype(idt).name)
    if key not in _GSA_INPUT_CACHE:
        from psac_tpu.parallel.collectives import global_cummax
        s = N // p

        def impl(xb_l, mapping, starts, ends, n_real):
            xs_l = jnp.take(mapping, xb_l.astype(jnp.int32))
            base = global_index_base(s)
            loc = starts - base
            ok = (loc >= 0) & (loc < s)
            mark = jnp.zeros((s + 1,), idt).at[
                jnp.where(ok, loc, s)].max(
                    jnp.where(ok, ends, jnp.asarray(0, idt)))[:s]
            eos_l = global_cummax(mark, p)
            g = (base + jnp.arange(s, dtype=jnp.int32)).astype(idt)
            eos_l = jnp.where(g < n_real, eos_l, g)
            return xs_l, eos_l

        x, r = P(AXIS), P()
        _GSA_INPUT_CACHE[key] = jax.jit(jax.shard_map(
            impl, mesh=mesh, in_specs=(x, r, r, r, r), out_specs=(x, x)))
    return _GSA_INPUT_CACHE[key]


def _flatten(strings) -> tuple[bytes, np.ndarray]:
    if isinstance(strings, (bytes, bytearray)):
        parts = [x for x in bytes(strings).split(b"\n") if x]
    else:
        parts = [bytes(x) for x in strings if len(x)]
    lens = np.array([len(x) for x in parts], np.int64)
    return b"".join(parts), lens


def _lcp_tiefix_local(lcp_l, sa_l, eos_l, *, s: int, p: int, N: int,
                      capscale: int | None = None):
    """Sentinel LCP rows (never-split groups of identical whole suffixes):
    LCP = the suffix's full length = eos[SA[g]] - SA[g]."""
    from psac_tpu.parallel.route import cap_for, route_apply

    r = lax.axis_index(AXIS).astype(jnp.int32)
    need = lcp_l == N
    dest = (jnp.clip(sa_l, 0, N - 1) // s).astype(jnp.int32)

    def gather(recv, recv_valid):
        (q,) = recv
        return (eos_l[jnp.clip(q - r * s, 0, s - 1)],)

    (eos_at_sa,), ovf = route_apply((sa_l,), dest, gather, (eos_l.dtype,), p,
                                    cap=cap_for(s, p, capscale), skip=~need,
                                    with_overflow=True)
    # dropped (overflowed) rows answer 0; a real answer is >= 1 (eos > sa),
    # so they keep the N sentinel and a full-capacity retry can find them
    return jnp.where(need & (eos_at_sa > 0), eos_at_sa - sa_l, lcp_l), ovf


def build_gsa_device(strings, mesh=None,
                     config: cfg_mod.SAConfig = cfg_mod.DEFAULT) -> DeviceGSA:
    """GSA (+GLCP) of a string set (list of byte strings, or one
    newline-separated flat byte string as the reference's ``gsac -f``);
    results stay device-resident."""
    mesh = mesh or make_mesh()
    p = num_shards(mesh)
    flat, lens = _flatten(strings)
    # ship raw uint8 text + the (m,) string ends; decode codes and expand
    # the per-position eos array ON DEVICE (eos as int32 would double the
    # host->device volume and bytes are 4x smaller than codes).  Per-shard
    # staging + a device-side alphabet histogram keep the host path
    # O(n/p)-light.
    from psac_tpu.parallel.staging import stage_bytes_block, staged_histogram

    xb, n, N = stage_bytes_block(flat, mesh)
    hist = staged_histogram(xb, mesh)
    alpha = Alphabet.from_hist(hist, pad_zeros=N - n)
    return _build_gsa_staged(xb, alpha, lens, n, N, mesh, p, config)


def _build_gsa_staged(xb, alpha, lens, n: int, N: int, mesh, p: int,
                      config: cfg_mod.SAConfig) -> DeviceGSA:
    """Shared device-side GSA pipeline from a staged (N,) uint8 flat text
    (separator-free) + host string lengths.  ``index_t``-generic like the
    reference's ``construct_ss`` (``include/suffix_array.hpp:269``): int64
    indexes at n >= 2^30 (or ``force_int64``)."""
    from psac_tpu.models.suffix_array import _x64_ctx, index_dtype_for

    idt = index_dtype_for(N, config)
    with _x64_ctx(idt):
        return _build_gsa_inner(xb, alpha, lens, n, N, mesh, p, config, idt)


def _build_gsa_inner(xb, alpha, lens, n: int, N: int, mesh, p: int,
                     config: cfg_mod.SAConfig, idt) -> DeviceGSA:
    np_idt = np.dtype(jnp.dtype(idt).name)
    m = len(lens)
    M = _pow2ceil(max(m, 1))
    ends_np = np.cumsum(lens).astype(np_idt)
    starts_p = np.full(M, N, np_idt)
    starts_p[:m] = (ends_np - lens).astype(np_idt)
    ends_p = np.zeros(M, np_idt)
    ends_p[:m] = ends_np
    rep = jax.sharding.NamedSharding(mesh, P())
    d_map = jax.device_put(alpha.mapping.astype(np.int32), rep)
    d_starts = jax.device_put(starts_p, rep)
    d_ends = jax.device_put(ends_p, rep)
    xs, eos = _gsa_inputs_fn(mesh, N, M, p, idt)(xb, d_map, d_starts, d_ends,
                                                 jnp.asarray(n, idt))

    from psac_tpu.models.suffix_array import kmer_words_for
    ks = kmer_words_for(alpha.bits_per_char, config)
    key = (mesh_key(mesh), N, ks, alpha.bits_per_char, config.construct_lcp,
           jnp.dtype(idt).name)
    if key not in _GSA_BUILDER_CACHE:
        if len(_GSA_BUILDER_CACHE) > 64:
            _GSA_BUILDER_CACHE.clear()
        _GSA_BUILDER_CACHE[key] = _GsaBuilder(
            mesh, N, ks, alpha.bits_per_char, config.construct_lcp, idt=idt)
    b = _GSA_BUILDER_CACHE[key]

    if config.fused:
        # one dispatch for the whole construction (init + dense while_loop
        # + eos-aware two-stage tail); a single (7,) readback
        m_cap2 = max(8 * b.p, min(N, _pow2ceil(max(256, N // 1024))))
        m_cap_f = max(m_cap2, min(N, _pow2ceil(N // 32)))
        fouts = b.gfused_full(m_cap_f, m_cap2,
                              resolve_div=config.resolve_div)(xs, eos)
        if config.construct_lcp:
            isa, sa, lcp, brow, _active, stats = fouts
        else:
            isa, sa, brow, _active, stats = fouts
            lcp = None
        ub_f, ue_f, tail_ran, _d_out, _dense_it, _tail_it, tie_ovf = (
            int(v) for v in np.asarray(jax.device_get(stats)))
        if ue_f == 0:
            if config.construct_lcp and tie_ovf > 0:
                # p > 1 only: the in-dispatch tiefix dropped rows; they kept
                # the N sentinel, so the full-capacity pass finds them
                lcp = _gsa_tiefix(lcp, sa, eos, b, mesh, p, N, config)
            return DeviceGSA(sa=sa, lcp=lcp, eos=eos, xs=xs, alphabet=alpha,
                             lens=lens, n=n, N=N, mesh=mesh)
        # pathological non-convergence (max_iters safety bound hit): redo
        # with the host-driven loop below rather than failing the build
        import sys
        print(f"[psac_tpu] fused GSA did not converge (ue={ue_f}); "
              "falling back to the host-driven loop", file=sys.stderr)

    outs = b._init(xs, eos)
    if config.construct_lcp:
        isa, sa, lcp, brow, active, eos_row, ub, ue = outs
    else:
        isa, sa, brow, active, eos_row, ub, ue = outs
        lcp = None
    ue = int(ue)

    d = sum(ks)
    tail_limit = int(N * config.tail_threshold_frac)
    while ue > 0:
        if d >= 4 * N:
            raise AssertionError("GSA doubling failed to converge")
        if 0 < ue <= tail_limit:
            # ---- eos-aware sparse tail (reference construct_msgs_gsa) ----
            m_cap = min(N, max(8 * b.p, _pow2ceil(ue)))
            # the active count equals ue from the last step: no readback
            cs, cb, ce, _total = b.tail_enter(m_cap)(sa, brow, active, eos_row)
            if ue <= m_cap:
                while ue > 0:
                    if config.construct_lcp:
                        cs, cb, ce, isa, sa, lcp, ue = b.tail_step(m_cap)(
                            cs, cb, ce, isa, sa, lcp, jnp.asarray(d, idt))
                    else:
                        cs, cb, ce, isa, sa, ue = b.tail_step(m_cap)(
                            cs, cb, ce, isa, sa, jnp.asarray(d, idt))
                    ue = int(ue)
                    d *= 2
                    if d >= 8 * N:
                        raise AssertionError("GSA tail failed to converge")
                break
        qd = min(d // b.s, b.p)
        if config.construct_lcp:
            isa, sa, lcp, qkey, lq, rq, nq, brow, active, eos_row, ub, ue = \
                b.step(qd)(isa, eos, lcp, jnp.asarray(d, idt))
            # one stacked readback instead of two round trips
            nq, ue = (int(v) for v in
                      np.asarray(jax.device_get(jnp.stack([nq, ue]))))
            if nq > 0:
                from psac_tpu.models.suffix_array import resolve_with_retry
                m_pad = min(max(_pow2ceil(nq), b.p), N)
                lcp = resolve_with_retry(b, m_pad, lcp, qkey, lq, rq,
                                         jnp.asarray(d, idt))
        else:
            isa, sa, brow, active, eos_row, ub, ue = b.step(qd)(isa, eos, jnp.asarray(d, idt))
            ue = int(ue)
        d *= 2

    if config.construct_lcp:
        lcp = _gsa_tiefix(lcp, sa, eos, b, mesh, p, N, config)

    return DeviceGSA(sa=sa, lcp=lcp, eos=eos, xs=xs, alphabet=alpha,
                     lens=lens, n=n, N=N, mesh=mesh)


def _gsa_tiefix(lcp, sa, eos, b, mesh, p: int, N: int, config):
    """Final sentinel-LCP fix (identical-whole-suffix ties), with routing
    capacity escalation on overflow."""
    for capscale in (6, None):
        fix = jax.jit(jax.shard_map(
            functools.partial(_lcp_tiefix_local, s=b.s, p=p, N=N,
                              capscale=capscale),
            mesh=mesh, in_specs=(P(AXIS),) * 3,
            out_specs=(P(AXIS), P())))
        lcp_fixed, ovf = fix(lcp, sa, eos)
        if capscale is None or p == 1 or int(ovf) == 0:
            break
    return lcp_fixed


_GSAC_STAGE_CACHE: dict = {}


def _gsac_stage_fn(mesh, N_file: int, N_flat: int, M: int, p: int, sep: int,
                   idt):
    """Jitted file-to-stringset staging: drop separator bytes (compacting the
    per-shard file blocks into the block-sharded separator-removed flat
    text) and emit the (M,) replicated separator file positions.

    The reference parses the distributed file into ``simple_dstringset``
    with strings split across rank boundaries
    (``include/stringset.hpp:43-152``); the TPU formulation needs no split
    machinery — each real byte's flat position is its file position minus
    the separators before it (a distributed exclusive scan), and one routed
    scatter reshards the compacted bytes."""
    from psac_tpu.parallel.collectives import exscan_scalar
    from psac_tpu.parallel.route import route_scatter

    key = (mesh_key(mesh), N_file, N_flat, M, sep, jnp.dtype(idt).name)
    if key not in _GSAC_STAGE_CACHE:
        sf = N_file // p
        s2 = N_flat // p

        def impl(fb_l, n_file):
            base = global_index_base(sf)
            g = (base + jnp.arange(sf, dtype=jnp.int32)).astype(idt)
            is_file = g < n_file
            msk = (fb_l == jnp.uint8(sep)) & is_file
            mi = msk.astype(idt)
            c_loc = jnp.cumsum(mi) - mi  # exclusive in-shard sep count
            c_base = exscan_scalar(jnp.sum(mi), p)
            c = c_base + c_loc  # separators strictly before g
            j = g - c  # flat (separator-removed) position
            real = is_file & ~msk
            bflat = jnp.zeros((s2,), jnp.uint8)
            (bflat,) = route_scatter(j, (fb_l,), (bflat,), real, s2, p)
            # sep ordinal c is globally unique: one shard writes each slot,
            # the psum of the zero-initialized partials replicates them
            sep_out = jnp.zeros((M + 1,), idt).at[
                jnp.where(msk, jnp.minimum(c, M), M)].set(
                    jnp.where(msk, g, jnp.asarray(0, idt)))[:M]
            return bflat, lax.psum(sep_out, AXIS)

        x, r = P(AXIS), P()
        _GSAC_STAGE_CACHE[key] = jax.jit(jax.shard_map(
            impl, mesh=mesh, in_specs=(x, r), out_specs=(x, r)))
    return _GSAC_STAGE_CACHE[key]


def build_gsa_from_file(path: str, mesh=None,
                        config: cfg_mod.SAConfig = cfg_mod.DEFAULT,
                        sep: int = 0x0A) -> DeviceGSA:
    """GSA (+GLCP) of a separator-delimited file (the reference's
    ``gsac -f``, ``src/gsac.cpp`` + ``include/stringset.hpp:43-152``), with
    per-process shard staging: no process reads or holds the whole string
    set (only the O(m) string-boundary metadata is replicated)."""
    from psac_tpu.models.suffix_array import _x64_ctx, index_dtype_for
    from psac_tpu.parallel.mesh import padded_size
    from psac_tpu.parallel.staging import stage_file_block, staged_histogram

    mesh = mesh or make_mesh()
    p = num_shards(mesh)
    xbf, n_file, N_file = stage_file_block(path, mesh)
    hist = staged_histogram(xbf, mesh)
    nsep = int(hist[sep])
    n_flat = n_file - nsep
    if n_flat <= 0:
        raise ValueError(f"{path}: no string content")
    N_flat = padded_size(n_flat, p, multiple=8)
    hist2 = hist.copy()
    hist2[sep] = 0
    # the histogram ran over the FILE-padded staging array, so its zero
    # count is the file padding (genuine NULs still raise)
    alpha = Alphabet.from_hist(hist2, pad_zeros=N_file - n_file)
    M = _pow2ceil(max(nsep, 1))
    idt = index_dtype_for(max(N_file, N_flat), config)
    with _x64_ctx(idt):
        xb_flat, sep_pos = _gsac_stage_fn(mesh, N_file, N_flat, M, p, sep,
                                          idt)(xbf, jnp.asarray(n_file, idt))
        sep_pos = np.asarray(jax.device_get(sep_pos), np.int64)[:nsep]
    ends_flat = sep_pos - np.arange(nsep, dtype=np.int64)
    if nsep == 0 or sep_pos[-1] != n_file - 1:
        ends_flat = np.concatenate([ends_flat, [n_flat]])
    lens = np.diff(np.concatenate([[0], ends_flat]))
    lens = lens[lens > 0]
    return _build_gsa_staged(xb_flat, alpha, lens, n_flat, N_flat, mesh, p,
                             config)


def build_gsa(strings, mesh=None,
              config: cfg_mod.SAConfig = cfg_mod.DEFAULT) -> GeneralizedSuffixArray:
    """Host-facing GSA construction (the reference's ``gsac`` output)."""
    flat, lens = _flatten(strings)
    if len(flat) == 0:
        return GeneralizedSuffixArray(
            sa=np.zeros(0, np.int64),
            lcp=np.zeros(0, np.int64) if config.construct_lcp else None,
            alphabet=Alphabet.from_bytes(flat), lens=lens, n=0)
    return build_gsa_device(strings, mesh, config).materialize()
