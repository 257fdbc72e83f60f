"""Dense-sort-wall microbenchmarks.

The adversarial 100 MB tier spends most of its time in full-width dense
iterations whose cost is the multi-operand ``lax.sort``.  This bench
measures the candidate structural levers on the accelerator:

  a) the baseline k-operand int32 sort at the dense iteration's shape,
  b) packing two 27-bit keys into one int64 lane (fewer comparator
     operands at ~2x per-lane cost — does emulated int64 win?),
  c) packing two 16-bit... (not applicable: bucket ids need ceil(log2 N)
     bits), so instead: dropping the payload operand by sorting
     (key..., gidx) with gidx folded into the last key's low bits when
     the key has headroom (exact when key < 2^(31 - log2 N) — it never
     is at 100M; measured anyway at 2^26 to quantify the ceiling),
  d) a 2-pass LSD radix via scatter (one pass is timed).

Usage: python benchmarks/sort_micro.py [log2n] [ops]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bench(label, fn, *args, reps=3):
    import jax
    out = fn(*args)
    jax.device_get(jax.tree.leaves(out)[0][:4])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.device_get(jax.tree.leaves(out)[0][:4])
        best = min(best, time.perf_counter() - t0)
    print(f"[sort_micro] {label}: {best * 1e3:.1f} ms", flush=True)
    return best


def main():
    e = int(sys.argv[1]) if len(sys.argv) > 1 else 26
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    n = 1 << e
    import jax
    import jax.numpy as jnp
    from jax import lax

    import psac_tpu
    psac_tpu.enable_compile_cache()

    rng = np.random.RandomState(0)
    dev = jax.devices()[0]
    cols32 = [jax.device_put(rng.randint(0, n, n).astype(np.int32), dev)
              for _ in range(k)]
    print(f"[sort_micro] n=2^{e}, {k} int32 operands "
          f"(keys={k - 1} + 1 payload)", flush=True)

    # (a) baseline: (k-1)-key int32 sort with payload
    bench(f"int32 sort {k - 1} keys + payload",
          jax.jit(lambda *c: lax.sort(c, num_keys=k - 1)), *cols32)

    # (b) pack key pairs into int64 lanes (27-bit values fit 2/lane)
    npairs = (k - 1) // 2
    rest = (k - 1) - 2 * npairs

    def packed(*c):
        keys = []
        for i in range(npairs):
            hi = c[2 * i].astype(jnp.int64)
            lo = c[2 * i + 1].astype(jnp.int64)
            keys.append((hi << 32) | lo)
        keys += [c[2 * npairs + j].astype(jnp.int64) for j in range(rest)]
        out = lax.sort(tuple(keys) + (c[-1],), num_keys=len(keys))
        return out[-1]

    bench(f"int64-packed sort {npairs + rest} keys + payload",
          jax.jit(packed), *cols32)

    # (d) one LSD radix pass: 8-bit histogram + scatter (cost of ONE of
    # the >= 4 passes a 27-bit radix needs)
    def radix_pass(key, payload):
        d = key & 0xFF
        order = jnp.argsort(d, stable=True)  # stand-in bucket phase
        return key[order], payload[order]

    def radix_scatter(key, payload):
        d = (key & 0xFF).astype(jnp.int32)
        counts = jnp.zeros((256,), jnp.int32).at[d].add(1)
        starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                  jnp.cumsum(counts)[:-1]])
        # rank within digit: stable one-pass via sort by digit (cheaper
        # formulations all need a scatter or a full sort anyway)
        order = jnp.argsort(d, stable=True)
        pos = jnp.zeros((n,), jnp.int32).at[order].set(
            jnp.arange(n, dtype=jnp.int32))
        out = jnp.zeros_like(key).at[pos].set(key)
        return out, starts

    bench("radix: ONE 8-bit pass (argsort+scatter formulation)",
          jax.jit(radix_scatter), cols32[0], cols32[1])

    # reference points
    bench("int32 sort 1 key + payload",
          jax.jit(lambda a, b: lax.sort((a, b), num_keys=1)),
          cols32[0], cols32[1])
    bench("int64 sort 1 key + payload",
          jax.jit(lambda a, b: lax.sort(
              ((a.astype(jnp.int64) << 32) | b.astype(jnp.int64), b),
              num_keys=1)), cols32[0], cols32[1])


if __name__ == "__main__":
    main()
