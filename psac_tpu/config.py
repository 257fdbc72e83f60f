"""Global tunables and dtype policy.

The reference hard-codes these as magic numbers (SURVEY.md §5 "Config"):
bucket-chaising threshold n/10 (reference ``include/suffix_array.hpp:424``),
TLLT size budget 2^24 (``include/desa.hpp:83``), TLDT maxsize n/p/128
(``include/tldt.hpp:426``). They are first-class config here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# Index dtype policy: int32 while n (padded) fits, else int64.
INT32_MAX = 2**31 - 1


def index_dtype(n: int):
    """Select the index dtype for a text of (padded) length ``n``.

    Mirrors the reference's ``index_t`` template parameter
    (``include/suffix_array.hpp:170``); int32 keeps sort keys and
    collectives at half the HBM traffic of int64.  The int32 ceiling is
    2^30: bucket ids reach N+1 and doubling distances reach 2N, both of
    which must stay below 2^31.
    """
    return jnp.int32 if n < (1 << 30) else jnp.int64


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """Configuration of suffix-array construction.

    Attributes:
      construct_lcp: also build the LCP array, interleaved with doubling
        (reference template flag ``_CONSTRUCT_LCP``).
      construct_lc: also build the left-branching-character array Lc
        (reference template flag ``_CONSTRUCT_LC``), needed by DESA; the
        result lands in ``DeviceSuffixArray.lc``.  Computed post-hoc as one
        bulk gather instead of the reference's interleaved ``bulk_rmq_Lc``
        maintenance (``include/suffix_array.hpp:1353-1396``), which would
        add a routed RMQ to every doubling iteration.
      k: initial k-mer length; 0 = auto (max chars that fit the sort key).
      tail_threshold_frac: switch to the sparse "bucket chaising" tail when
        unfinished elements < n * frac (reference uses 1/10,
        ``suffix_array.hpp:424``).
      tail_capacity_mult: padded capacity multiplier for the compacted
        active set in the sparse tail.
      factor: prefix-multiplication factor per dense iteration: 2 = classic
        doubling; 3/4 = the reference's ``construct_arr<L>`` tripling/
        quadrupling (SA-only; no LCP support, as in the reference).
      fused: dispatch k-mer init + the dense loop + the whole sparse tail
        as ONE device program with a single stats readback instead of one
        host<->device round trip per iteration; falls back to the
        host-driven loop only if the dense loop hits its iteration bound.
      force_int64: build with int64 indexes even for small texts (texts of
        >= 2^30 chars select int64 automatically — the reference's uint64
        ``index_t`` builds, ``src/psac.cpp:54``).
    """

    construct_lcp: bool = True
    construct_lc: bool = False
    k: int = 0
    tail_threshold_frac: float = 0.1
    tail_capacity_mult: float = 1.25
    factor: int = 2
    fused: bool = True
    force_int64: bool = False
    # dense-phase prefix-multiplication factor of the fused path
    # (2 = doubling; 3/4/8 = L-pling WITH interleaved LCP — beyond the
    # reference, whose construct_arr<L> is SA-only): sort width grows
    # linearly with L, iteration count shrinks by log L, so repeat-heavy
    # corpora win at higher L until the L+1 live operands bind HBM
    dense_factor: int = 4
    # LCP-resolve chunk divisor of the fused path: chunk = s / resolve_div
    # (chosen on the previous target; re-tuned per ROADMAP A7)
    resolve_div: int = 32
    # pack pairs of 31-bit sort-key columns into int64 lanes in the wide
    # (>= 6 column) dense sorts: fewer sort operands at the price of an
    # x64 trace context and pack/unpack passes.  Off by default; the knob
    # + parity test remain until it is decided on the GPU (ROADMAP C4)
    pack_keys: bool = False
    # int32 words of the initial k-mer ranking (the reference packs ONE
    # machine word, include/kmer.hpp:25-40; more words deepen the initial
    # rank — 3 words = 30 chars for DNA, 12 for byte text — saving a dense
    # iteration on repeat-heavy corpora at one extra init sort operand)
    kmer_words: int = 2
    # fused-path tail-entry capacity = N / fused_tail_div: the dense
    # while_loop hands over to the big-stage sparse tail once the active
    # count fits (the host path uses tail_threshold_frac instead).  A
    # smaller divisor enters the tail earlier: tail iterations cost
    # O(cap) sorts + routed gathers vs the dense iteration's O(N) sorts,
    # a win once most elements are finished
    fused_tail_div: int = 32


DEFAULT = SAConfig()
