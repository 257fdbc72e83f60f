"""k-mer packing (per-shard compute; vectorized equivalent of reference include/kmer.hpp).

The reference packs k chars MSB-first into one machine word so that integer
order equals lexicographic order (``include/kmer.hpp:119-177``), choosing
``k = get_optimal_k`` to fill the word (``include/kmer.hpp:25-40``). Here a
k-mer is a *tuple* of int32 words — lexicographic order of the tuple is
k-mer order — so the hot sort stays on int32 lanes (half the bytes of
int64 keys).  Two words is the default; three words deepen the initial
ranking (k = 30 for DNA, 12 for byte text), saving a dense doubling
iteration on repeat-heavy corpora at one extra sort operand.

Per-shard packing needs a halo of the next shard's first k-1 chars; the
wrapper in ``psac_tpu.parallel`` provides it via one ``ppermute``.
"""

from __future__ import annotations

import jax.numpy as jnp


def optimal_k(bits_per_char: int, max_bits: int = 31,
              words: int = 2) -> tuple[int, ...]:
    """Chars per int32 word (sign bit kept zero), for ``words`` words."""
    per_word = max(1, max_bits // bits_per_char)
    return (per_word,) * words


def pack_kmers_local(chars_with_halo, s: int, ks: tuple[int, ...], bits: int):
    """Pack sum(ks)-mers for the s window starts of this shard.

    Args:
      chars_with_halo: (s + sum(ks) - 1,) int32 encoded chars (codes
        1..sigma, 0 = padding/sentinel), the shard's chars followed by the
        halo from the right neighbor (zeros past the end of the text).
      s: number of window starts (the shard size).
      ks: chars per word, MSB-first word order.
    Returns:
      tuple of len(ks) (s,) int32 arrays comparing like the k-mer.
    """
    words = []
    off = 0
    for kw in ks:
        w = jnp.zeros((s,), jnp.int32)
        for j in range(off, off + kw):
            w = jnp.left_shift(w, bits) | chars_with_halo[j:j + s]
        words.append(w)
        off += kw
    return tuple(words)


def pack_kmers_host(codes, ks: tuple[int, ...], bits: int):
    """NumPy single-host reference of pack_kmers_local (for tests/oracles)."""
    import numpy as np

    n = len(codes)
    k = sum(ks)
    padded = np.concatenate([np.asarray(codes, np.int64),
                             np.zeros(k - 1, np.int64)])
    words = []
    off = 0
    for kw in ks:
        w = np.zeros(n, np.int64)
        for j in range(off, off + kw):
            w = (w << bits) | padded[j:j + n]
        words.append(w.astype(np.int32))
        off += kw
    return tuple(words)
