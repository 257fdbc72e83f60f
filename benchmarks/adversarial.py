"""Profiling harness for the adversarial 100 MB long-repeat `text` tier.

Runs SA+LCP construction with per-iteration section timers (PSAC_TIMER=1,
unfused host loop so every phase syncs) or timed fused runs, sweeping the
dense-phase levers: kmer_words, dense_factor, resolve_div, and the
tail-entry capacity fraction.

Usage: python benchmarks/adversarial.py [profile|sweep] [n]
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "profile"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000_000
    corpus = os.environ.get("ADV_CORPUS", "text")

    from benchmarks.envelope import bench_corpus_text, sync, time_construct
    text = bench_corpus_text(n, corpus)

    import jax  # noqa: F401
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu import config as cfg
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard
    from psac_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(1)

    if mode in ("profile", "profile-sa"):
        # profile-sa: SA-only unfused quad path (construct_arr<4>) — per-iter
        # sort/rebucket/tail splits + the unfinished-element trajectory;
        # the LCP-resolve share = fused-total minus these parts.
        os.environ["PSAC_TIMER"] = "1"
        conf = dataclasses.replace(
            cfg.DEFAULT, fused=False,
            construct_lcp=(mode == "profile"),
            factor=int(os.environ.get("ADV_FACTOR", 4)),
            kmer_words=int(os.environ.get("ADV_WORDS", 2)),
            dense_factor=int(os.environ.get("ADV_FACTOR", 4)),
            tail_threshold_frac=float(os.environ.get("ADV_TAIL", 0.1)))
        xs, alpha, n_, N = encode_and_shard(text, mesh, conf)
        sync(xs)
        t0 = time.perf_counter()
        d = construct_device(xs, alpha, n_, N, mesh, conf)
        sync(d.sa)
        print(f"[adv] {corpus} {n}: unfused profile total "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        return

    # sweep: fused best-of-N per config (fixed seeds live in
    # envelope.bench_corpus_text; reruns on the same code must agree)
    reps = int(os.environ.get("ADV_REPS", 3))
    combos = [dict()]  # baseline W=2 F=4 rdiv=32
    spec = os.environ.get(
        "ADV_SWEEP", "dense_factor=8;kmer_words=3;resolve_div=8")
    for part in filter(None, spec.split(";")):
        combos.append({k: int(v) for k, v in
                       (kv.split("=") for kv in part.split(","))})
    results = []
    for c in combos:
        conf = dataclasses.replace(cfg.DEFAULT, **c)
        dt = time_construct(text, mesh, reps=reps, conf=conf)
        print(f"[adv] {corpus} {n}: {c} -> {dt:.2f}s (best of {reps})",
              flush=True)
        results.append({"config": c, "seconds": round(dt, 2)})
    import json
    best = min(results, key=lambda r: r["seconds"])
    print(json.dumps({"metric": f"adversarial {corpus} SA+LCP wall time",
                      "value": best["seconds"], "unit": "s", "n": n,
                      "reps": reps, "best_config": best["config"],
                      "sweep": results}), flush=True)


if __name__ == "__main__":
    main()
