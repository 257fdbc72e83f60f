"""Distributed suffix tree construction from SA+LCP (reference include/suffix_tree.hpp).

The tree is the reference's flat representation: one potential internal node
per LCP entry, sigma+1 child slots per node (slot 0 = the ``$`` edge);
``nodes[i][c] = id`` of the child reached from internal node ``i`` by an
edge whose label starts with character ``c``.  Node ids: internal node =
its LCP index (root = 0), leaf for SA position j = ``n + j``.

Parent edges are derived exactly as the reference's ``for_each_parent``
(``include/suffix_tree.hpp:44-223``):

  * leaf j: parent is the larger of LCP[j], LCP[j+1]; ties and the
    left case use the left furthest_eq ANSV match when its value equals
    LCP[j] (canonical duplicate), else node j itself;
  * internal node i (LCP[i] > 0): parent is the ANSV match with the larger
    LCP value (left furthest_eq wins ties); a node whose left match has an
    *equal* value is a duplicate and emits no edge;
  * each edge's child slot is the character at text[SA[i] + parent_depth]
    (slot 0 past the end of the text).

Device pipeline: one distributed ANSV (``psac_tpu.parallel.ansv``),
one bulk character gather, and one scatter of (parent, slot) -> child id
into the block-sharded flat node table — all inside a single shard_map.
Padding positions (the first N-n entries of the padded arrays) take LCP
value -1 so they act as transparent sentinels and emit no edges.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from psac_tpu.models.suffix_array import (
    DeviceSuffixArray,
    _pow2ceil,
    construct_device,
    encode_and_shard,
)
from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_SM
from psac_tpu.parallel.ansv import ansv_local, nonsv_for
from psac_tpu.parallel.collectives import (
    global_index_base,
    halo_from_left,
    halo_from_right,
)
from psac_tpu.parallel.mesh import AXIS, make_mesh, mesh_key, num_shards
from psac_tpu.parallel.route import cap_for, route_apply, route_scatter


@dataclasses.dataclass
class DeviceSuffixTree:
    """Block-sharded flat node table ((N * (sigma+1),) int32; padding rows unused)."""

    nodes: jax.Array
    sigma: int
    n: int
    N: int

    def materialize(self) -> np.ndarray:
        flat = np.asarray(jax.device_get(self.nodes), dtype=np.int64)
        full = flat.reshape(self.N, self.sigma + 1)
        return full[self.N - self.n:]


def _parent_edges(lcp_l, sa_l, s: int, p: int, n: int,
                  capscale: int | None = None):
    """Shared `for_each_parent` computation (leaf + internal edges).

    Returns per-edge (parents [padded coords], childs [node ids], elcp
    [parent depth], savals, valid), each of length 2s (leaf block then
    internal block), plus the routing-overflow count.

    Node ids, the ANSV match indices, and the LCP values all carry the
    build's index dtype (the reference's ``index_t``-templated node table,
    ``include/suffix_tree.hpp:479``): leaf ids reach 2n-1, so int64 builds
    stay exact past n = 2^30."""
    idt = lcp_l.dtype
    inf = nonsv_for(idt)
    N = s * p
    off = N - n
    g = (global_index_base(s) + jnp.arange(s, dtype=jnp.int32)).astype(idt)
    is_real = g >= off

    lcp_adj = jnp.where(is_real, lcp_l, jnp.asarray(-1, idt))
    lcp_adj = jnp.where(g == off, jnp.asarray(0, idt), lcp_adj)

    lidx, lval, ridx, rval, ovf = ansv_local(
        lcp_adj, s, p, FURTHEST_EQ, NEAREST_SM, capscale=capscale)

    nxt = halo_from_right(lcp_adj, 1, p, fill=0)
    lcp_next = jnp.concatenate([lcp_adj[1:], nxt])
    # the globally last element always takes the left case (fill 0 <= lcp)
    lcp_cur = lcp_adj

    # ---- leaf edges (one per real position) -------------------------------
    left_case = lcp_cur >= lcp_next
    dup = (lval == lcp_cur) & (lidx != inf)
    leaf_parent = jnp.where(left_case, jnp.where(dup, lidx, g), g + 1)
    leaf_elcp = jnp.where(left_case, lcp_cur, lcp_next)
    leaf_child = jnp.asarray(n, idt) + (g - off)
    leaf_valid = is_real

    # ---- internal-node edges ----------------------------------------------
    use_left = (ridx == inf) | (lval >= rval)
    int_parent = jnp.where(use_left, lidx, ridx)
    int_elcp = jnp.where(use_left, lval, rval)
    int_child = g - off
    int_valid = is_real & (g > off) & (lcp_cur > 0) & (lval != lcp_cur)

    parents = jnp.concatenate([leaf_parent, int_parent])
    childs = jnp.concatenate([leaf_child, int_child])
    elcp = jnp.concatenate([leaf_elcp, int_elcp])
    savals = jnp.concatenate([sa_l, sa_l])
    valid = jnp.concatenate([leaf_valid, int_valid])
    return parents, childs, elcp, savals, valid, ovf


def _gather_from(arr_l, idx, valid, s: int, p: int,
                 capscale: int | None = None):
    """Bulk gather arr[idx] from a block-sharded array (invalid -> 0).

    Returns (values, overflow-count); ``capscale`` bounds the routing
    buffers (reference ``bulk_rma``'s all2allv moves O(m); the capped
    exchange matches that for balanced index distributions).  Query indices
    and answers carry their own dtypes (int64-clean for >2^31-char texts)."""
    N = s * p
    safe = jnp.clip(jnp.where(valid, idx, 0), 0, N - 1)
    dest = (safe // s).astype(jnp.int32)
    base = lax.axis_index(AXIS).astype(safe.dtype) * s

    def gather(recv, recv_valid):
        (q,) = recv
        return (arr_l[jnp.clip((q - base).astype(jnp.int32), 0, s - 1)],)

    (out,), ovf = route_apply((safe,), dest, gather, (arr_l.dtype,), p,
                              cap=cap_for(idx.shape[0], p, capscale),
                              skip=~valid, with_overflow=True)
    return jnp.where(valid, out, 0), ovf


def _st_local(lcp_l, sa_l, xs_l, *, s: int, p: int, n: int, sigma: int,
              capscale: int | None = None):
    parents, childs, elcp, savals, valid, ovf = _parent_edges(
        lcp_l, sa_l, s, p, n, capscale)

    # ---- first character of each edge (bulk gather from the text) ---------
    char_idx = savals + elcp
    dollar = char_idx >= n
    ch, ovf_g = _gather_from(xs_l, char_idx, valid & ~dollar, s, p, capscale)
    slot = jnp.where(dollar, 0, ch)

    # ---- scatter child ids into the (N rows, sigma+1 slots) node table ----
    # routed by (node row, slot): the flat global index N*(sigma+1) (the
    # reference's uint64-addressed table, include/suffix_tree.hpp:479)
    # never materializes, so byte-alphabet texts need no int64 promotion;
    # the table itself carries the index dtype (leaf ids reach 2n-1)
    width = sigma + 1
    nodes = jnp.zeros((s * width,), lcp_l.dtype)
    (nodes,), ovf_s = route_scatter(
        parents, (childs,), (nodes,), valid, s, p,
        cap=cap_for(parents.shape[0], p, capscale), with_overflow=True,
        width=width, slots=slot)
    return nodes, ovf + ovf_g + ovf_s


def _gst_local(lcp_l, sa_l, xs_l, eos_l, *, s: int, p: int, n: int, sigma: int,
               dlr_cap: int, capscale: int | None = None):
    """Generalized suffix tree node table (reference ``construct_gst``,
    ``include/suffix_tree.hpp:521-608``): sigma+2 slots per node; slots 0-1
    hold the (min, max) child-id range of all ``$``-edges (one string may
    end per leaf, many per node); root-depth edges (lcp 0) are not recorded
    (reference drops ``root_edges``, suffix_tree.hpp:546-552)."""
    parents, childs, elcp, savals, valid, ovf = _parent_edges(
        lcp_l, sa_l, s, p, n, capscale)
    idt = lcp_l.dtype
    width = sigma + 2
    INF = jnp.iinfo(idt).max

    # ``$``-edge test without an eos[SA[i]] gather: every edge has depth
    # elcp >= 1 (rootdrop) and elcp <= eos[SA[i]] - SA[i] (GLCP never
    # exceeds the suffix length), so char_idx = SA[i] + elcp lies in
    # (SA[i], eos[SA[i]]] — strictly inside SA[i]'s own string unless it
    # IS the string end.  A string end < n is the NEXT string's start, so
    # ``$`` <=> char_idx is a string-start position (or char_idx == n).
    # Fold a start bit into the gathered text: ONE 2s-row gather answers
    # both the edge char and the ``$`` test (a separate s-row eos gather
    # would cost one more full random-gather pass).
    g_txt = global_index_base(s).astype(idt) + jnp.arange(s, dtype=idt)
    prev_eos = halo_from_left(eos_l, 1, p, fill=0)
    eos_prev = jnp.concatenate([prev_eos, eos_l[:-1]])
    is_start = (g_txt == 0) | (eos_prev == g_txt)
    xz_l = xs_l + jnp.asarray(sigma + 1, xs_l.dtype) * is_start

    char_idx = savals + elcp
    rootdrop = elcp == 0
    dollar_end = char_idx >= jnp.asarray(n, idt)
    valid_q = valid & ~rootdrop
    chz, ovf2 = _gather_from(xz_l, char_idx, valid_q & ~dollar_end,
                             s, p, capscale)
    dollar = dollar_end | (chz > sigma)
    ch = chz  # non-$ rows carry no start bit
    valid_reg = valid_q & ~dollar
    valid_dlr = valid_q & dollar

    # slot 0 accumulates a min: initialize via an elementwise iota mask (a
    # 16M strided scatter costs ~10x one pass over the table)
    slot0 = jnp.arange(s * width, dtype=jnp.int32) % width == 0
    nodes = jnp.where(slot0, INF, 0).astype(idt)

    scap = cap_for(parents.shape[0], p, capscale)
    # routed by (node row, slot) — see route_scatter: no flat N*width index
    (nodes,), ovf3 = route_scatter(parents, (childs,), (nodes,), valid_reg,
                                   s, p, cap=scap, with_overflow=True,
                                   width=width, slots=ch + 1)
    # ``$``-edges are rare (bounded by suffixes that fully match another
    # suffix's prefix): compact them to ``dlr_cap`` rows before the min/max
    # scatters — a min/max scatter pays all 2s rows otherwise (compaction
    # instead of a full-width scatter-combine is a lowering choice made on
    # the previous target; ROADMAP C3).
    # Overflow joins the capscale retry (which re-enters with dlr_cap = 2s).
    key_d = jnp.where(valid_dlr, parents, INF)
    key_c, child_c = lax.sort((key_d, childs), num_keys=1)
    key_c, child_c = key_c[:dlr_cap], child_c[:dlr_cap]
    valid_c = key_c != INF
    n_dlr = jnp.sum(valid_dlr.astype(jnp.int32))
    ovf_c = lax.psum(jnp.maximum(n_dlr - jnp.int32(dlr_cap), 0), AXIS)
    row_d = jnp.where(valid_c, key_c, 0)
    dcap = cap_for(dlr_cap, p, capscale)
    zero_slots = jnp.zeros_like(row_d)
    (nodes,), ovf4 = route_scatter(row_d, (child_c,), (nodes,), valid_c,
                                   s, p, combine=("min",), cap=dcap,
                                   with_overflow=True, width=width,
                                   slots=zero_slots)
    (nodes,), ovf5 = route_scatter(row_d, (child_c,), (nodes,), valid_c,
                                   s, p, combine=("max",), cap=dcap,
                                   with_overflow=True, width=width,
                                   slots=zero_slots + 1)
    nodes = jnp.where(slot0 & (nodes == INF), 0, nodes)
    return nodes, ovf + ovf2 + ovf3 + ovf4 + ovf5 + ovf_c


def _check_local_table(s: int, width: int, idx_dtype) -> None:
    """Node scatters route by (row, slot), so only the PER-SHARD flat table
    index ``s*width`` must fit the local index dtype (int32 builds index
    locally in int32; int64 builds index in int64, matching the reference's
    uint64 index_t table, ``include/suffix_tree.hpp:479``).  An s*width
    beyond int32 on an int32 build means >8 GB of node table per shard —
    shard over more devices instead."""
    if s * width >= (1 << 31) and jnp.dtype(idx_dtype) != jnp.int64:
        raise ValueError(
            f"per-shard node table s*width = {s * width} exceeds int32 local "
            f"addressing on an int32 build; use more shards (or force_int64)")


_ST_CACHE: dict = {}


def construct_suffix_tree_device(dsa: DeviceSuffixArray, xs, mesh) -> DeviceSuffixTree:
    """Build the flat suffix tree from a device-resident SA+LCP and the
    encoded padded text ``xs`` (as produced by ``encode_and_shard``).  The
    node table follows the SA's index dtype (int64 builds trace int64 node
    ids — the reference's index_t table, include/suffix_tree.hpp:479)."""
    from psac_tpu.models.suffix_array import _x64_ctx

    if dsa.lcp is None:
        raise ValueError("suffix tree construction requires the LCP array")
    p = num_shards(mesh)
    s = dsa.N // p
    sigma = dsa.alphabet.sigma
    idt = jnp.dtype(dsa.sa.dtype)
    _check_local_table(s, sigma + 1, idt)
    with _x64_ctx(idt):
        for capscale in (6, None):
            key = (mesh_key(mesh), dsa.N, dsa.n, sigma, capscale, idt.name)
            if key not in _ST_CACHE:
                fn = jax.shard_map(
                    functools.partial(_st_local, s=s, p=p, n=dsa.n,
                                      sigma=sigma, capscale=capscale),
                    mesh=mesh, in_specs=(P(AXIS),) * 3,
                    out_specs=(P(AXIS), P()))
                _ST_CACHE[key] = jax.jit(fn)
            nodes, ovf = _ST_CACHE[key](dsa.lcp, dsa.sa, xs)
            if capscale is None or p == 1 or int(ovf) == 0:
                break
    return DeviceSuffixTree(nodes=nodes, sigma=sigma, n=dsa.n, N=dsa.N)


def build_suffix_tree(text: bytes | np.ndarray, mesh=None,
                      config=None) -> np.ndarray:
    """Host convenience: SA+LCP construction + suffix tree; returns the
    (n, sigma+1) int64 node table (the reference's ``psac -t`` output)."""
    mesh = mesh or make_mesh()
    xs, alpha, n, N = encode_and_shard(text, mesh)
    kw = {} if config is None else {"config": config}
    dsa = construct_device(xs, alpha, n, N, mesh, **kw)
    return construct_suffix_tree_device(dsa, xs, mesh).materialize()


_GST_CACHE: dict = {}


def construct_gst_device(dgsa) -> DeviceSuffixTree:
    """Generalized suffix tree from a device-resident GSA (+GLCP)."""
    from psac_tpu.models.suffix_array import _x64_ctx

    if dgsa.lcp is None:
        raise ValueError("GST construction requires the GLCP array")
    mesh = dgsa.mesh
    p = num_shards(mesh)
    s = dgsa.N // p
    sigma = dgsa.alphabet.sigma
    idt = jnp.dtype(dgsa.sa.dtype)
    _check_local_table(s, sigma + 2, idt)
    m = max(1, len(dgsa.lens))
    # first-try $-edge compaction capacity.  Random string sets produce
    # ~log_sigma(n) $-leaves PER STRING (every suffix short enough to match
    # another suffix's prefix gets one), so size by a generous multiple of
    # m; a middle rung covers heavy-duplication sets, and the final rung is
    # the exact worst case 2s (correct but pays the slow full-width
    # min/max scatters).
    dlr0 = min(2 * s, max(1 << 16, 16 * _pow2ceil(m)))
    ladder = [(6, dlr0)]
    if 64 * dlr0 < 2 * s:
        ladder.append((None, 64 * dlr0))
    ladder.append((None, 2 * s))
    with _x64_ctx(idt):
        for i, (capscale, dlr_cap) in enumerate(ladder):
            key = (mesh_key(mesh), dgsa.N, dgsa.n, sigma, capscale, dlr_cap,
                   idt.name)
            if key not in _GST_CACHE:
                fn = jax.shard_map(
                    functools.partial(_gst_local, s=s, p=p, n=dgsa.n,
                                      sigma=sigma, dlr_cap=dlr_cap,
                                      capscale=capscale),
                    mesh=mesh, in_specs=(P(AXIS),) * 4,
                    out_specs=(P(AXIS), P()))
                _GST_CACHE[key] = jax.jit(fn)
            nodes, ovf = _GST_CACHE[key](dgsa.lcp, dgsa.sa, dgsa.xs, dgsa.eos)
            if i == len(ladder) - 1 or int(ovf) == 0:
                break
    return DeviceSuffixTree(nodes=nodes, sigma=sigma + 1, n=dgsa.n, N=dgsa.N)


def build_gst(strings, mesh=None) -> np.ndarray:
    """Host convenience: GSA construction + generalized suffix tree; returns
    the (n, sigma+2) int64 node table."""
    from psac_tpu.models.gsa import build_gsa_device

    mesh = mesh or make_mesh()
    dgsa = build_gsa_device(strings, mesh=mesh)
    return construct_gst_device(dgsa).materialize()
