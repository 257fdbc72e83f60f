"""DESA bulk_locate throughput by pattern length.

Builds a 2^27 (or DESA_E) random-DNA index on the accelerator and measures
q/s at pattern lengths 8 / 20 / 64, batch 65536.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax  # noqa: F401
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu.models.desa import build_desa
    from psac_tpu.ops.alphabet import rand_dna
    from psac_tpu.parallel.mesh import make_mesh

    n = 1 << int(os.environ.get("DESA_E", 27))
    mesh = make_mesh(1)
    text = rand_dna(n, seed=7)
    t0 = time.perf_counter()
    desa = build_desa(text, mesh=mesh)
    print(f"[desa] construct 2^{n.bit_length()-1}: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    rng = np.random.RandomState(1)  # fixed seed: reruns must be comparable
    B = int(os.environ.get("DESA_B", 65536))
    reps = int(os.environ.get("DESA_REPS", 3))
    qps = {}
    for L in (8, 20, 64):
        starts = rng.randint(0, n - L, B)
        pats = [text[s:s + L] for s in starts]
        desa.bulk_locate(pats)  # compile + warm (full batch: same shapes)
        best = float("inf")
        for rep in range(reps):
            t0 = time.perf_counter()
            ranges = desa.bulk_locate(pats)
            rt = time.perf_counter() - t0
            print(f"[desa] len {L} rep {rep}: {rt:.3f}s", flush=True)
            best = min(best, rt)
        hits = int((ranges[:, 1] > ranges[:, 0]).sum())
        assert hits == B, (hits, B)  # every pattern is a real substring
        qps[f"len{L}"] = round(B / best)
        print(f"[desa] len {L}: {B / best / 1e3:.0f}K q/s "
              f"(best of {reps}: {best:.2f}s for {B})", flush=True)
    import json
    print(json.dumps({"metric": "DESA bulk_locate throughput",
                      "value": qps, "unit": "q/s", "n": n, "batch": B,
                      "reps": reps, "seed": 1}), flush=True)


if __name__ == "__main__":
    main()
