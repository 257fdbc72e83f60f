"""ANSV primitive timings on the suffix tree's pass.

Times, on the LCP array of 2^e random DNA (native SA-IS + Kasai on the
host, so the numbers do not depend on the device SA build):
  - the suffix tree's ANSV pass (left ``furthest_eq`` + right
    ``nearest_sm``) through ``parallel.ansv.ansv_local`` on a one-device
    mesh, i.e. the engine ``PSAC_NSV`` selects (default ``block``),
  - its strict previous-smaller pass alone (``bansv.block_psv``),
  - the value gather at the matches,
  - a 2-operand compaction sort of the same width.

Usage: python benchmarks/ansv_micro.py [log2n]
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(label, fn, *args, reps=3):
    """Best-of-``reps`` wall time after one warm-up call; returns the output
    and the time in seconds."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"[ansv_micro] {label}: {best * 1e3:.2f} ms", flush=True)
    return out, best


def dna_lcp(n: int, seed: int = 7) -> np.ndarray:
    """int32 LCP array of ``rand_dna(n, seed)`` from the native oracle."""
    from psac_tpu import native
    from psac_tpu.ops.alphabet import rand_dna

    text = rand_dna(n, seed=seed)
    return native.lcp_array(text, native.suffix_array(text)).astype(np.int32)


def st_pass_fn(mesh, s: int):
    """Jitted single-shard ANSV with the suffix tree's match types."""
    import jax
    from jax.sharding import PartitionSpec as P

    from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_SM
    from psac_tpu.parallel.ansv import ansv_local
    from psac_tpu.parallel.mesh import AXIS

    return jax.jit(jax.shard_map(
        functools.partial(ansv_local, s=s, p=1, left_type=FURTHEST_EQ,
                          right_type=NEAREST_SM),
        mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS),) * 4 + (P(),)))


def main():
    e = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    n = 1 << e
    import jax
    import jax.numpy as jnp
    from jax import lax

    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu.ops.bansv import block_psv
    from psac_tpu.parallel.mesh import block_sharding, make_mesh

    d = jax.devices()[0]
    print(f"[ansv_micro] device: {d.platform} {d.device_kind}; n={n}",
          flush=True)
    mesh = make_mesh(1)
    lcp = jax.device_put(dna_lcp(n), block_sharding(mesh))
    bench("ST pass (furthest_eq left, nearest_sm right)",
          st_pass_fn(mesh, n), lcp)
    idx_psv, _ = bench("block_psv strict",
                       jax.jit(lambda a: block_psv(a, True)), lcp)
    bench("x[psv] gather",
          jax.jit(lambda a, i: a[jnp.maximum(i, 0)]), lcp, idx_psv)
    bench("2-op compaction sort",
          jax.jit(lambda a, b: lax.sort((a, b), num_keys=1)), lcp, idx_psv)


if __name__ == "__main__":
    main()
