"""Benchmark envelope beyond the headline bench.py config.

Modes (select with argv[1]):
  chip     — single-accelerator runs: SA+LCP at 2^24..2^28 random DNA,
             repetitive 2^24, DESA bulk_locate on a 2^28 index.
  scaling  — virtual CPU mesh p in {1,2,4,8} SA+LCP scaling curve
             (shape-only: CPU timings do not model the device
             interconnect, but expose collective-volume scaling).
  st       — suffix tree end-to-end + ST-only at 2^24 DNA on the selected
             ANSV engine (PSAC_NSV), plus GSA+GST timing.
  corpus   — SA+LCP on the repetitive/text/textmix tiers sweeping
             SAConfig.kmer_words (the W-word initial ranking) and the
             native SA-IS baseline ratio.

Results are recorded in PERF.md with the device they ran on.
"""
import os
import sys
import time

import numpy as np

# runnable as `python benchmarks/envelope.py` from the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync(x):
    import jax
    jax.block_until_ready(x)


def time_construct(text, mesh, reps=2, conf=None):
    import psac_tpu
    from psac_tpu import config as cfg
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard

    conf = conf or cfg.DEFAULT
    xs, alpha, n, N = encode_and_shard(text, mesh, conf)
    sync(xs)
    construct_device(xs, alpha, n, N, mesh, conf)  # compile + warm
    best = float("inf")
    d = None
    for _ in range(reps):
        del d  # free the previous result's device buffers first
        t0 = time.perf_counter()
        d = construct_device(xs, alpha, n, N, mesh, conf)
        sync(d.sa)
        best = min(best, time.perf_counter() - t0)
    del d, xs
    return best


def chip():
    import jax
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu.ops.alphabet import rand_dna, rep_dna
    from psac_tpu.parallel.mesh import make_mesh

    print("devices:", jax.devices(), flush=True)
    mesh = make_mesh(1)

    for e in (24, 25, 26, 27, 28):
        n = 1 << e
        try:
            dt = time_construct(rand_dna(n, seed=42), mesh)
            print(f"[env] SA+LCP random 2^{e}: {dt:.2f}s "
                  f"({n / dt / 1e6:.0f} MB/s)", flush=True)
        except Exception as ex:  # noqa: BLE001 - report OOM tiers
            print(f"[env] SA+LCP random 2^{e}: FAILED ({type(ex).__name__}: "
                  f"{str(ex)[:120]})", flush=True)
            break

    try:
        dt = time_construct(rep_dna(1 << 24, seed=0), mesh)
        print(f"[env] SA+LCP repetitive 2^24: {dt:.2f}s", flush=True)
    except Exception as ex:  # noqa: BLE001
        print(f"[env] repetitive: FAILED ({str(ex)[:120]})", flush=True)

    # DESA on the largest index that fits; bulk_locate throughput
    from psac_tpu.models.desa import build_desa
    for e in (28, 27, 26):
        n = 1 << e
        text = rand_dna(n, seed=7)
        try:
            t0 = time.perf_counter()
            desa = build_desa(text, mesh=mesh)
            dt = time.perf_counter() - t0
            print(f"[env] DESA construct 2^{e}: {dt:.2f}s", flush=True)
            rng = np.random.RandomState(1)
            B = 65536
            pats = []
            for _ in range(B):
                st = rng.randint(0, n - 20)
                pats.append(text[st:st + 20])
            desa.bulk_locate(pats[:1024])  # compile
            t0 = time.perf_counter()
            ranges = desa.bulk_locate(pats)
            dt = time.perf_counter() - t0
            hits = int((ranges[:, 1] > ranges[:, 0]).sum())
            print(f"[env] DESA bulk_locate 2^{e} idx, {B} pats len 20: "
                  f"{B / dt / 1e3:.0f}K q/s ({hits} hits)", flush=True)
            break
        except Exception as ex:  # noqa: BLE001
            print(f"[env] DESA 2^{e}: FAILED ({type(ex).__name__}: "
                  f"{str(ex)[:120]})", flush=True)
    print("done", flush=True)


def scaling():
    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from psac_tpu.ops.alphabet import rand_dna
    from psac_tpu.parallel.mesh import make_mesh

    n = 1 << 22
    text = rand_dna(n, seed=42)
    base = None
    for p in (1, 2, 4, 8):
        dt = time_construct(text, make_mesh(p))
        base = base or dt
        print(f"[env] CPU scaling p={p}: {dt:.2f}s "
              f"(speedup {base / dt:.2f}x)", flush=True)
    print("done", flush=True)


def bench_corpus_text(n, kind):
    """The bench.py text/textmix stand-in corpora (same seeds)."""
    import glob
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parts = []
    for f in sorted(glob.glob(os.path.join(root, "psac_tpu/**/*.py"),
                              recursive=True)) + \
            sorted(glob.glob(os.path.join(root, "*.md"))):
        with open(f, "rb") as fh:
            parts.append(fh.read())
    unit = np.frombuffer(b"".join(parts).replace(b"\x00", b" "), np.uint8)
    rng = np.random.RandomState(7)
    if kind == "text":
        reps = -(-n // len(unit))
        arr = np.tile(unit, reps)[:n].copy()
        idx = rng.randint(0, n, max(1, n // 4096))
        arr[idx] = rng.randint(32, 127, len(idx))
    else:
        m = n // 64 + 2
        lens = rng.randint(64, 513, m)
        cut = int(np.searchsorted(np.cumsum(lens), n)) + 1
        lens = lens[:cut]
        starts = rng.randint(0, len(unit) - 600, len(lens))
        ends = np.cumsum(lens)
        begins = ends - lens
        pos = np.arange(ends[-1], dtype=np.int64)
        seg = np.searchsorted(ends, pos, side="right")
        arr = unit[starts[seg] + (pos - begins[seg])][:n].copy()
    return arr.tobytes()


def st():
    import jax
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard
    from psac_tpu.models.suffix_tree import construct_suffix_tree_device
    from psac_tpu.ops.alphabet import rand_dna
    from psac_tpu.parallel.mesh import make_mesh

    print("devices:", jax.devices(), flush=True)
    mesh = make_mesh(1)
    n = 1 << 24
    text = rand_dna(n, seed=42)
    xs, alpha, n_, N = encode_and_shard(text, mesh)
    sync(xs)

    from psac_tpu.parallel.ansv import _engine
    engine = _engine()
    # SA+LCP once (shared by both engines)
    construct_device(xs, alpha, n_, N, mesh)  # warm
    t0 = time.perf_counter()
    dsa = construct_device(xs, alpha, n_, N, mesh)
    sync(dsa.sa)
    t_sa = time.perf_counter() - t0
    print(f"[env] SA+LCP 2^24 DNA: {t_sa:.2f}s", flush=True)

    construct_suffix_tree_device(dsa, xs, mesh)  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        dst = construct_suffix_tree_device(dsa, xs, mesh)
        sync(dst.nodes)
        best = min(best, time.perf_counter() - t0)
        del dst
    print(f"[env] ST-only ({engine}): {best:.2f}s; end-to-end "
          f"{t_sa + best:.2f}s", flush=True)

    # ANSV-only breakdown with the ST's match types, on the raw LCP array
    # (NOT the padding-masked lcp_adj the ST feeds — equivalent work at
    # p=1 with no padding, but not byte-identical input)
    import functools

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_SM
    from psac_tpu.parallel.ansv import ansv_local
    from psac_tpu.parallel.mesh import AXIS

    fn = jax.jit(jax.shard_map(
        functools.partial(ansv_local, s=N, p=1, left_type=FURTHEST_EQ,
                          right_type=NEAREST_SM),
        mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS),) * 4 + (P(),)))
    lcp32 = dsa.lcp.astype(jnp.int32)
    sync(fn(lcp32)[0])  # warm
    best = float("inf")
    ovf = 0
    for _ in range(3):
        t0 = time.perf_counter()
        outs = fn(lcp32)
        sync(outs[0])
        best = min(best, time.perf_counter() - t0)
        ovf = max(ovf, int(outs[4]))
    tag = f" [WARNING: {ovf} routing overflows -> results incomplete, " \
          f"time not comparable]" if ovf else ""
    print(f"[env] ANSV-only ({engine}, FURTHEST_EQ/NEAREST_SM): "
          f"{best:.2f}s{tag}", flush=True)

    from psac_tpu.models.gsa import build_gsa_device
    from psac_tpu.models.suffix_tree import construct_gst_device
    strings = [rand_dna(4096, seed=i) for i in range(4096)]
    t0 = time.perf_counter()
    dgsa = build_gsa_device(strings, mesh=mesh)
    sync(dgsa.sa)
    t_gsa0 = time.perf_counter() - t0  # incl. compile
    t0 = time.perf_counter()
    dgsa = build_gsa_device(strings, mesh=mesh)
    sync(dgsa.sa)
    t_gsa = time.perf_counter() - t0
    print(f"[env] GSA 4096x4KiB: {t_gsa:.2f}s (cold {t_gsa0:.1f}s)",
          flush=True)
    construct_gst_device(dgsa)  # warm
    t0 = time.perf_counter()
    dgst = construct_gst_device(dgsa)
    sync(dgst.nodes)
    print(f"[env] GST-only: {time.perf_counter() - t0:.2f}s", flush=True)
    print("done", flush=True)


def corpus():
    import dataclasses

    import jax  # noqa: F401
    import psac_tpu
    psac_tpu.enable_compile_cache()
    from psac_tpu import config as cfg
    from psac_tpu import native
    from psac_tpu.ops.alphabet import rep_dna
    from psac_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    tiers = []
    sel = os.environ.get("PSAC_ENV_TIERS", "repetitive,text,textmix")
    if "repetitive" in sel:
        tiers.append(("repetitive 2^24", rep_dna(1 << 24, seed=0)))
    if "text" in sel:
        tiers.append(("text 100MB", bench_corpus_text(100_000_000, "text")))
    if "textmix" in sel:
        tiers.append(("textmix 100MB",
                      bench_corpus_text(100_000_000, "textmix")))
    words = [int(w) for w in
             os.environ.get("PSAC_ENV_WORDS", "2,3").split(",")]
    rdivs = [int(r) for r in
             os.environ.get("PSAC_ENV_RDIV", "32").split(",")]
    facs = [int(f) for f in
            os.environ.get("PSAC_ENV_FACTOR", "4").split(",")]
    for name, text in tiers:
        t0 = time.perf_counter()
        sa_ref = native.suffix_array(text)
        native.lcp_array(text, sa_ref)
        base_t = time.perf_counter() - t0
        del sa_ref
        print(f"[env] {name}: native SA-IS+Kasai {base_t:.2f}s", flush=True)
        for w in words:
            for rd in rdivs:
                for fa in facs:
                    conf = dataclasses.replace(cfg.DEFAULT, kmer_words=w,
                                               resolve_div=rd,
                                               dense_factor=fa)
                    dt = time_construct(text, mesh, reps=2, conf=conf)
                    print(f"[env] {name}: W={w} rdiv={rd} F={fa} {dt:.2f}s "
                          f"({base_t / dt:.2f}x SA-IS)", flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    modes = (sys.argv[1] if len(sys.argv) > 1 else "chip").split(",")
    if "scaling" in modes and modes != ["scaling"]:
        # scaling() must own the process: it sets XLA_FLAGS (host device
        # count) + jax_platforms=cpu, which only take effect before the JAX
        # backend initializes — after any other mode it would see 1 device,
        # and any mode after it would run on CPU
        raise SystemExit("mode 'scaling' must run alone (its env overrides "
                         "only apply before JAX backend init)")
    for mode in modes:  # comma-separated modes share one process (one
        # backend initialization + one persistent-cache namespace)
        {"chip": chip, "scaling": scaling, "st": st, "corpus": corpus}[mode]()
