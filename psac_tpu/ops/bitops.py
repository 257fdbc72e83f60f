"""Bit-level primitives (vectorized JAX equivalents of reference include/bitops.hpp).

The reference packs k-mers MSB-first into machine words so that integer order
equals lexicographic order, and computes the LCP of two k-mers via XOR +
count-leading-zeros (reference ``include/bitops.hpp:169-183``). Here k-mers
are packed into *pairs* of int32 words (hi, lo) so that the sort keys stay
int32; lexicographic order of the pair equals k-mer order.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def ceillog2(x: int) -> int:
    """Smallest b with 2**b >= x (host-side)."""
    return max(0, int(x - 1).bit_length())


def lcp_bitwise32(a, b, k: int, bits: int):
    """Number of leading equal ``bits``-wide chars of two k-mers packed in int32.

    The k-mers occupy the low ``k*bits`` bits (MSB-first chars), with the
    int32 sign bit and any slack above ``k*bits`` guaranteed zero.
    Vectorized equivalent of reference ``include/bitops.hpp:169-183``.
    """
    x = jnp.bitwise_xor(a, b)
    # clz over the 32-bit word; subtract the dead top bits to get the
    # position of the first differing bit inside the k*bits window.
    lz = lax.clz(x) - (32 - k * bits)
    lcp = lz // bits
    return jnp.where(x == 0, jnp.int32(k), lcp.astype(jnp.int32))


def lcp_bitwise_pair(ahi, alo, bhi, blo, k1: int, k2: int, bits: int):
    """LCP of two (k1+k2)-char k-mers packed as (hi, lo) int32 pairs."""
    return lcp_bitwise_words((ahi, alo), (bhi, blo), (k1, k2), bits)


def lcp_bitwise_words(a_words, b_words, ks: tuple[int, ...], bits: int):
    """LCP of two sum(ks)-char k-mers packed as tuples of int32 words
    (MSB-first word order): accumulate per-word LCPs while all previous
    words are equal."""
    lcp = None
    live = None  # all previous words equal
    for aw, bw, kw in zip(a_words, b_words, ks):
        lw = lcp_bitwise32(aw, bw, kw, bits)
        if lcp is None:
            lcp, live = lw, aw == bw
        else:
            lcp = jnp.where(live, lcp + lw, lcp)
            live = live & (aw == bw)
    return lcp


def kmer_char_at(kmer, k: int, bits: int, pos):
    """Extract the char at position ``pos`` (0-based from the left) of a packed k-mer.

    Equivalent of reference ``include/kmer.hpp:65`` (``get_kmer_char``); used to
    decode the left-branching character Lc during initial k-mer LCP.
    """
    shift = (k - 1 - pos) * bits
    return jnp.right_shift(kmer, shift) & ((1 << bits) - 1)
