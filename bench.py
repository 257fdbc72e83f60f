#!/usr/bin/env python
"""Headline benchmark: input bytes/s/chip for SA+LCP construction.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

- Runs on the GPU(s) JAX sees (power-of-two subset) and fails without one;
  prints the device and the card's name and power limit on stderr.
- Correctness gate: SA and LCP byte-identical to the native SA-IS + Kasai
  oracle (the reference's psac-vs-dss methodology, src/psac_vs_dss.cpp:110).
- vs_baseline = our throughput / native sequential SA-IS+Kasai throughput on
  this host (the divsufsort-class baseline; BASELINE.md records no published
  reference numbers).

Env knobs: PSAC_BENCH_N (default 2^26), PSAC_BENCH_CORPUS
("dna"|"repetitive"|"text"|"textmix"|"bytes"), PSAC_BENCH_FACTOR
(dense prefix-L-pling factor, default SAConfig.dense_factor),
PSAC_BENCH_RESOLVE_DIV (LCP-resolve chunk divisor), PSAC_BENCH_KMER_WORDS
(init k-mer words), PSAC_BENCH_FILE (path to a real corpus file — the
first PSAC_BENCH_N bytes are used; overrides PSAC_BENCH_CORPUS).

Real-corpus recipe (BASELINE config #2 names enwik8; the benchmark assumes
no network, so "text"/"textmix" are deterministic in-repo stand-ins): on a
networked machine run
    curl -LO https://mattmahoney.net/dc/enwik8.zip && unzip enwik8.zip
    # sha1 57b8363b814821dc9d47aa4d41f58733519076b2  (enwik8, 10^8 bytes)
then PSAC_BENCH_FILE=enwik8 PSAC_BENCH_N=100000000 python bench.py.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from psac_tpu.utils.device import card_line, require_gpu
    dev = require_gpu()
    log(f"device: {dev}; card: {card_line()}")
    n = int(os.environ.get("PSAC_BENCH_N", 1 << 26))
    corpus = os.environ.get("PSAC_BENCH_CORPUS", "dna")

    from psac_tpu.ops.alphabet import rand_dna, rep_dna
    if os.environ.get("PSAC_BENCH_FILE"):
        with open(os.environ["PSAC_BENCH_FILE"], "rb") as fh:
            text = fh.read(n).replace(b"\x00", b" ")
        n = len(text)
    elif corpus == "dna":
        text = rand_dna(n, seed=42)
    elif corpus == "repetitive":
        text = rep_dna(n, seed=0)
    elif corpus in ("text", "textmix"):
        # English-like stand-ins for enwik8 (zero egress), built from this
        # repo's own sources: "text" tiles them whole (an ADVERSARIAL
        # long-repeat corpus: ~700 KB repeat unit), "textmix" concatenates
        # random 64-512 B slices (diverse, bounded repeats — the closer
        # stand-in for real mixed text)
        import glob
        root = os.path.dirname(os.path.abspath(__file__))
        parts = []
        for f in sorted(glob.glob(os.path.join(root, "psac_tpu/**/*.py"),
                                  recursive=True)) + \
                sorted(glob.glob(os.path.join(root, "*.md"))):
            with open(f, "rb") as fh:
                parts.append(fh.read())
        unit = np.frombuffer(
            b"".join(parts).replace(b"\x00", b" "), np.uint8)
        rng = np.random.RandomState(7)
        if corpus == "text":
            reps = -(-n // len(unit))
            arr = np.tile(unit, reps)[:n].copy()
            idx = rng.randint(0, n, max(1, n // 4096))
            arr[idx] = rng.randint(32, 127, len(idx))
        else:
            m = n // 64 + 2
            lens = rng.randint(64, 513, m)
            # keep slices through the first one whose cumulative length
            # covers n (guaranteed: worst case 64*m >= n + 128)
            cut = int(np.searchsorted(np.cumsum(lens), n)) + 1
            lens = lens[:cut]
            starts = rng.randint(0, len(unit) - 600, len(lens))
            # index array = concat of [starts[i], starts[i]+lens[i])
            ends = np.cumsum(lens)
            begins = ends - lens
            pos = np.arange(ends[-1], dtype=np.int64)
            seg = np.searchsorted(ends, pos, side="right")
            arr = unit[starts[seg] + (pos - begins[seg])][:n].copy()
            assert len(arr) == n
        text = arr.tobytes()
    else:
        rng = np.random.RandomState(42)
        text = rng.randint(1, 256, size=n, dtype=np.uint8).tobytes()

    # ---- native sequential baseline (SA-IS + Kasai), best of 2
    from psac_tpu import native
    base_t = float("inf")
    for _ in range(2):
        t0 = time.time()
        sa_ref = native.suffix_array(text)
        lcp_ref = native.lcp_array(text, sa_ref)
        base_t = min(base_t, time.time() - t0)
    base_bps = n / base_t
    log(f"baseline sais+kasai: {base_t:.2f}s ({base_bps/1e6:.2f} MB/s)")

    import jax
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard
    from psac_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    p = 1 << (ndev.bit_length() - 1)  # largest power of two <= ndev
    mesh = make_mesh(p)
    log(f"devices: {jax.devices()} -> mesh of {p}")

    # Timed region: device-resident input -> device-resident SA+LCP (the
    # reference likewise keeps results distributed per rank, never gathered).
    import dataclasses

    from psac_tpu import config as _cfg
    conf = _cfg.DEFAULT
    if os.environ.get("PSAC_BENCH_FACTOR"):
        conf = dataclasses.replace(
            conf, dense_factor=int(os.environ["PSAC_BENCH_FACTOR"]))
    if os.environ.get("PSAC_BENCH_RESOLVE_DIV"):
        conf = dataclasses.replace(
            conf, resolve_div=int(os.environ["PSAC_BENCH_RESOLVE_DIV"]))
    if os.environ.get("PSAC_BENCH_KMER_WORDS"):
        conf = dataclasses.replace(
            conf, kmer_words=int(os.environ["PSAC_BENCH_KMER_WORDS"]))
    reps = int(os.environ.get("PSAC_BENCH_REPS", 3))
    xs, alpha, n_, N = encode_and_shard(text, mesh, conf)
    construct_device(xs, alpha, n_, N, mesh, conf).block_until_ready()  # warm-up
    # best-of-N timed reps: a single rep cannot tell host noise from a
    # real regression
    dt = float("inf")
    for rep in range(reps):
        t0 = time.time()
        dres = construct_device(xs, alpha, n_, N, mesh, conf)
        dres.block_until_ready()
        rt = time.time() - t0
        log(f"rep {rep}: {rt:.3f}s ({n / rt / 1e6:.2f} MB/s)")
        dt = min(dt, rt)
    bps = n / dt
    log(f"psac_tpu SA+LCP: {dt:.2f}s ({bps/1e6:.2f} MB/s on {p} device(s))")

    res = dres.materialize()
    ok = np.array_equal(res.sa, sa_ref) and np.array_equal(res.lcp, lcp_ref)
    if not ok:
        log("CORRECTNESS GATE FAILED: SA/LCP do not match the native oracle")
        print(json.dumps({
            "metric": "SA+LCP construction bytes/s/chip (FAILED correctness)",
            "value": 0.0, "unit": "bytes/s/chip", "vs_baseline": 0.0,
        }))
        sys.exit(1)
    log("correctness gate: SA+LCP identical to native SA-IS+Kasai oracle")

    value = bps / p
    print(json.dumps({
        "metric": "SA+LCP construction throughput",
        "value": round(value, 1),
        "unit": "bytes/s/chip",
        "vs_baseline": round(bps / base_bps, 3),
        "device": dev,
    }))


if __name__ == "__main__":
    main()
