"""Distributed multi-key sort over the mesh axis (the mxx::sort replacement).

The reference's single most performance-critical backend call is the
distributed sample sort ``mxx::sort`` (SURVEY.md §2 L0: ``idxsort.hpp:60``,
``suffix_array.hpp:723,758,1191``). Sample sort needs ragged all-to-all
exchanges, which SPMD/XLA cannot express with static shapes — so the
mesh design is a **merge-split bitonic sort of sorted shard blocks**:

  1. each shard sorts its block locally (``lax.sort``, multi-key),
  2. the bitonic network over p blocks runs log2(p)*(log2(p)+1)/2
     compare-exchange stages; each stage is one full-shard ``ppermute`` to the
     partner plus a local 2s merge, keeping the lower or upper half.

Every stage has static shapes and moves s-element messages between device
pairs. By
the 0-1 principle, merge-split bitonic over locally-sorted blocks yields a
globally sorted, block-distributed result for arbitrary inputs.

Scatter-by-permutation (the reference's ``bulk_permute_inplace``,
``include/bulk_permute.hpp:13-73``, used for the SA->ISA step) is sorting by
the destination index: values land exactly block-aligned.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from psac_tpu.parallel.mesh import AXIS


def _merge_split(operands, partner_ops, num_keys: int, take_lower, am_lower_rank):
    """Merge two sorted blocks; keep lower or upper half per ``take_lower``.

    Both partners must compute the *identical* merged sequence or ties would
    be split inconsistently: concatenate in canonical (lower-rank first)
    order and use a stable sort.
    """
    s = operands[0].shape[0]
    firsts = tuple(jnp.where(am_lower_rank, a, b) for a, b in zip(operands, partner_ops))
    seconds = tuple(jnp.where(am_lower_rank, b, a) for a, b in zip(operands, partner_ops))
    merged = lax.sort(
        tuple(jnp.concatenate([a, b]) for a, b in zip(firsts, seconds)),
        num_keys=num_keys, is_stable=True,
    )
    lower = tuple(m[:s] for m in merged)
    upper = tuple(m[s:] for m in merged)
    return tuple(jnp.where(take_lower, lo, up) for lo, up in zip(lower, upper))


def dist_sort_local(operands: tuple, num_keys: int, p: int):
    """Globally sort block-distributed arrays by their first ``num_keys`` operands.

    Call inside shard_map; ``operands`` are the local (s,) blocks. Ties are
    broken arbitrarily unless the caller includes a unique key (e.g. the
    global index) among the keys, which also makes the result deterministic.

    Power-of-two shard counts run the bitonic network
    (log2(p)*(log2(p)+1)/2 stages); other counts run odd-even block
    transposition (p stages — correct for ANY p by the 0-1 principle, used
    for awkward device counts like the reference's 13-rank MPI tests).
    """
    operands = lax.sort(tuple(operands), num_keys=num_keys, is_stable=False)
    if p == 1:
        return operands
    if p & (p - 1):
        return _odd_even_sort_local(operands, num_keys, p)
    i = lax.axis_index(AXIS)
    m = p.bit_length() - 1
    for k in range(1, m + 1):
        for j in reversed(range(k)):
            partner_perm = [(a, a ^ (1 << j)) for a in range(p)]
            partner_ops = tuple(lax.ppermute(o, AXIS, partner_perm) for o in operands)
            ascending = (i & (1 << k)) == 0
            is_lower_idx = (i & (1 << j)) == 0
            take_lower = jnp.logical_not(jnp.logical_xor(ascending, is_lower_idx))
            operands = _merge_split(operands, partner_ops, num_keys, take_lower, is_lower_idx)
    return operands


def _odd_even_sort_local(operands: tuple, num_keys: int, p: int):
    """Odd-even block transposition over locally-sorted blocks: p rounds of
    neighbor merge-splits (round r pairs blocks (2i+r%2, 2i+1+r%2); edge
    blocks without a partner pass through as ppermute self-pairs)."""
    i = lax.axis_index(AXIS)
    for r in range(p):
        off = r % 2
        partner = []
        for a in range(p):
            if a < off or (a - off) % 2 == 0:
                b = a + 1 if (a >= off and a + 1 < p) else a
            else:
                b = a - 1
            partner.append(b)
        perm = [(a, partner[a]) for a in range(p)]
        partner_ops = tuple(lax.ppermute(o, AXIS, perm) for o in operands)
        pvec = jnp.asarray(partner, jnp.int32)[i]
        paired = pvec != i
        is_lower = i < pvec
        merged = _merge_split(operands, partner_ops, num_keys,
                              take_lower=is_lower, am_lower_rank=is_lower)
        operands = tuple(jnp.where(paired, m, o)
                         for m, o in zip(merged, operands))
    return operands


def scatter_by_index_local(dest_idx, values: tuple, p: int):
    """ISA-update scatter: result[dest_idx[j]] = values[j], dest a permutation.

    Distributed sort by the destination index leaves each value block-aligned
    at its destination (reference ``bulk_permute_inplace`` equivalent).
    Returns the sorted value tuple (destination order).
    """
    out = dist_sort_local((dest_idx, *values), num_keys=1, p=p)
    return out[1:]
