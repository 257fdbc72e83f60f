#!/usr/bin/env python
"""Smoke run of every pipeline on the GPU, each phase gated by an oracle.

One process drives the card.  Phases, in order, each compared with an
independent oracle by exact integer equality (nothing here is floating
point, so no tolerance arises):

  1. SA+LCP of 2^26 random DNA on a one-device mesh: one fused dispatch,
     byte-identical to the native SA-IS + Kasai oracle; prints the fused
     program's ``memory_analysis()`` and how XLA lowered its sorts.
  2. SA+LCP of 2^24 repetitive DNA (dense quadrupling loop + two-stage
     sparse tail), then the same text with ``force_int64`` indexes.
  3. Suffix tree: gated against the Python interval oracle at 2^20, then
     built at 2^24 for time only (the oracle takes minutes there).
  4. GSA + GST of a string set gated against the naive sorted-suffix and
     GST oracles, then 4096 strings x 4 KiB for time only.
  5. DESA on the 2^26 text with both top-level indexes (``tllt``,
     ``tldt``): ``bulk_locate`` of 1024 patterns at each of the lengths
     8, 20 and 64, half sampled from the text and half absent, against an
     exact window scan of the text.

``--four-cards`` runs instead, on a four-device mesh, SA+LCP of 2^27
random DNA and the suffix tree phase, and checks that the shards sit on
four distinct devices.

Every timing printed is a smoke timing (first call including compilation,
then the best of 3 warm calls synced with ``block_until_ready``), not a
benchmark result.  The last line is one JSON object naming the device.
Exits non-zero, with no result line, when JAX finds no GPU or a phase
fails.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import numpy as np

REPS = 3


def log(*a):
    print("[smoke]", *a, flush=True)


def _peak() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "not reported" if peak is None else f"{peak / 2**30:.3f} GiB"


def _sync(out):
    """Wait for every device array of ``out`` (a result dataclass, or any
    pytree) to be computed."""
    import jax

    if dataclasses.is_dataclass(out):
        jax.block_until_ready([getattr(out, f.name)
                               for f in dataclasses.fields(out)])
    else:
        jax.block_until_ready(out)
    return out


def _timed(fn, reps: int = REPS):
    """(result, first-call seconds, best warm seconds); every call ends when
    its device work has finished."""
    t0 = time.perf_counter()
    out = _sync(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = _sync(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _report(label: str, first: float, best: float, extra: str = ""):
    log(f"{label}: first call (compile + run) {first:.3f} s, "
        f"best-of-{REPS} {best:.4f} s [smoke timing, not a benchmark]; "
        f"peak device memory so far {_peak()}{extra}")


_ORACLE: dict = {}


def _native_oracle(key, text: bytes):
    """Native SA-IS + Kasai of ``text`` (host, ctypes), cached per text."""
    from psac_tpu import native

    if key not in _ORACLE:
        t0 = time.perf_counter()
        sa = native.suffix_array(text)
        _ORACLE[key] = (sa, native.lcp_array(text, sa))
        log(f"native SA-IS+Kasai oracle for {key}: "
            f"{time.perf_counter() - t0:.1f} s (host)")
    return _ORACLE[key]


def _dna(kind: str, n: int, seed: int) -> bytes:
    from psac_tpu.ops.alphabet import rand_dna, rep_dna

    return rand_dna(n, seed=seed) if kind == "random" else rep_dna(n, seed=seed)


def _gate(ok, msg: str) -> None:
    """A phase's pass/fail check (kept under ``python -O``, unlike
    ``assert``)."""
    if not ok:
        raise AssertionError(msg)


def _check_placement(arr, mesh):
    """The block-sharded result occupies every device of the mesh."""
    devs = {sh.device for sh in arr.addressable_shards}
    want = set(mesh.devices.flat)
    _gate(devs == want and len(devs) == mesh.size,
          f"shards on {sorted(d.id for d in devs)}, mesh devices "
          f"{sorted(d.id for d in want)}")


def sort_lowering(hlo: str) -> dict:
    """Counts of the sort implementations in an optimized HLO module:
    library custom calls (radix sort) by target, and comparator ``sort``
    instructions."""
    out = {"comparator_sort": len(re.findall(r"\ssort\(", hlo))}
    for tgt in re.findall(r'custom_call_target="([^"]*)"', hlo):
        if "sort" in tgt.lower():
            out[tgt] = out.get(tgt, 0) + 1
    return out


def phase_sa(mesh, n: int, kind: str = "random", seed: int = 42,
             force_int64: bool = False, show_program: bool = False) -> dict:
    """SA+LCP through ``encode_and_shard`` + ``construct_device``: one fused
    dispatch, byte-identical to the native oracle."""
    from psac_tpu import config as cfg
    from psac_tpu.models.suffix_array import (
        LAST_BUILD, compile_fused, construct_device, encode_and_shard)
    from psac_tpu.parallel.mesh import num_shards

    text = _dna(kind, n, seed)
    sa_ref, lcp_ref = _native_oracle((kind, n, seed), text)
    conf = dataclasses.replace(cfg.DEFAULT, force_int64=force_int64)
    xs, alpha, n_, N = encode_and_shard(text, mesh, conf)
    dsa, first, best = _timed(
        lambda: construct_device(xs, alpha, n_, N, mesh, conf))
    build = dict(LAST_BUILD.d)
    _gate(build.get("fused") and build.get("host_iters") == 0,
          f"construction was not ONE fused dispatch: {build}")
    _check_placement(dsa.sa, mesh)
    res = dsa.materialize()
    _gate(np.array_equal(res.sa, sa_ref), "SA != native SA-IS")
    _gate(np.array_equal(res.lcp, lcp_ref), "LCP != native Kasai")
    label = (f"SA+LCP {kind} DNA n={n} p={num_shards(mesh)} "
             f"{np.dtype(dsa.sa.dtype).name}")
    _report(label, first, best,
            f"; fused while_loop trips: dense={build.get('dense_iters')} "
            f"tail={build.get('tail_iters')}; OK (byte-identical to native "
            "SA-IS+Kasai)")
    if show_program:
        t0 = time.perf_counter()
        compiled = compile_fused(xs, alpha, n_, N, mesh, conf)
        log(f"fused SA+LCP program (n={n}): AOT compile "
            f"{time.perf_counter() - t0:.3f} s; memory_analysis: "
            f"{compiled.memory_analysis()}")
        log(f"fused SA+LCP program sort lowering: "
            f"{sort_lowering(compiled.as_text())}")
    return {"first": first, "best": best, **build}


def phase_st(mesh, n_gate: int, n_time: int = 0) -> dict:
    """Suffix tree through ``construct_suffix_tree_device``: gated against
    the interval oracle at ``n_gate``; built at ``n_time`` for time only."""
    from psac_tpu.models.suffix_array import construct_device, encode_and_shard
    from psac_tpu.models.suffix_tree import construct_suffix_tree_device
    from psac_tpu.verify.suffix_tree_oracle import suffix_tree_oracle

    text = _dna("random", n_gate, 12)
    sa_ref, lcp_ref = _native_oracle(("random", n_gate, 12), text)
    xs, alpha, n_, N = encode_and_shard(text, mesh)
    t0 = time.perf_counter()
    want = suffix_tree_oracle(alpha.encode(text), sa_ref, lcp_ref,
                              alpha.sigma)
    log(f"suffix tree oracle n={n_gate}: {time.perf_counter() - t0:.1f} s "
        "(host)")
    dsa = construct_device(xs, alpha, n_, N, mesh)
    st = construct_suffix_tree_device(dsa, xs, mesh)
    _check_placement(st.nodes, mesh)
    _gate(np.array_equal(st.materialize(), want), "suffix tree != oracle")
    log(f"suffix tree n={n_gate}: OK (node table equals the interval oracle)")
    if not n_time:
        return {}
    del dsa, st, xs
    text = _dna("random", n_time, 13)
    xs, alpha, n_, N = encode_and_shard(text, mesh)
    dsa, first, best = _timed(
        lambda: construct_device(xs, alpha, n_, N, mesh))
    _report(f"SA+LCP for the suffix tree n={n_time}", first, best)
    _, sfirst, sbest = _timed(
        lambda: construct_suffix_tree_device(dsa, xs, mesh))
    _report(f"suffix tree only n={n_time} (unchecked: the Python oracle "
            "takes minutes at this size)", sfirst, sbest,
            f"; SA+LCP+ST {best + sbest:.4f} s")
    return {"sa_best": best, "st_best": sbest}


def phase_gsa(mesh, m_gate: int, len_gate: int, m_time: int = 0,
              len_time: int = 0) -> dict:
    """GSA + GST through ``build_gsa_device`` + ``construct_gst_device``:
    gated at ``m_gate`` strings of up to ``len_gate`` chars; ``m_time``
    strings of ``len_time`` chars for time only."""
    from psac_tpu.models.gsa import build_gsa_device
    from psac_tpu.models.suffix_tree import construct_gst_device
    from psac_tpu.ops.alphabet import Alphabet, rand_dna
    from psac_tpu.ops.oracle import gsa_naive
    from psac_tpu.verify.suffix_tree_oracle import gst_oracle

    rng = np.random.RandomState(13)
    strings = [rand_dna(int(ln), seed=100 + i) for i, ln in
               enumerate(rng.randint(2, len_gate + 1, size=m_gate))]
    # a few exact and prefix duplicates exercise the GSA tie rule and
    # multi-string $-edges
    strings += strings[:4] + [s[: len(s) // 2] for s in strings[4:8]]
    flat = b"".join(strings)
    lens = np.array([len(x) for x in strings], np.int64)
    eos = np.repeat(np.cumsum(lens), lens)
    t0 = time.perf_counter()
    sa_ref, lcp_ref = gsa_naive(strings)
    alpha = Alphabet.from_bytes(flat)
    want_gst = gst_oracle(alpha.encode(flat), sa_ref, lcp_ref, eos,
                          alpha.sigma)
    log(f"GSA/GST oracles ({len(strings)} strings, {len(flat)} chars): "
        f"{time.perf_counter() - t0:.1f} s (host)")
    dgsa = build_gsa_device(strings, mesh=mesh)
    res = dgsa.materialize()
    _gate(np.array_equal(res.sa, sa_ref), "GSA != sorted-suffix oracle")
    _gate(np.array_equal(res.lcp, lcp_ref), "GLCP != sorted-suffix oracle")
    gst = construct_gst_device(dgsa).materialize()
    _gate(np.array_equal(gst, want_gst), "GST != oracle")
    log(f"GSA+GLCP+GST of {len(strings)} strings: OK (equal to the oracles)")
    out = {}
    if m_time:
        big = [rand_dna(len_time, seed=i) for i in range(m_time)]
        dgsa, first, best = _timed(lambda: build_gsa_device(big, mesh=mesh))
        _report(f"GSA+GLCP {m_time} x {len_time} (unchecked)", first, best)
        _, gfirst, gbest = _timed(lambda: construct_gst_device(dgsa))
        _report(f"GST-only {m_time} x {len_time} (unchecked)", gfirst, gbest)
        out = {"gsa_best": best, "gst_best": gbest}
    return out


def _window_keys(codes: np.ndarray, m: int) -> np.ndarray:
    """uint64 key of every length-m window (2 bits per DNA code, m <= 32)."""
    nw = len(codes) - m + 1
    key = np.zeros(nw, np.uint64)
    for j in range(m):
        key <<= np.uint64(2)
        key |= codes[j:j + nw]
    return key


def occurrences(text: bytes, patterns: list[bytes]) -> list[np.ndarray]:
    """Start positions of every pattern in a DNA text, by an exact scan of
    every text window (windows keyed by their first <= 32 chars, longer
    patterns verified char by char)."""
    lut = np.full(256, 255, np.uint8)
    for c, b in enumerate(b"ACGT"):
        lut[b] = c
    codes = lut[np.frombuffer(text, np.uint8)]
    _gate((codes < 4).all(), "occurrence scan expects an ACGT text")
    codes = codes.astype(np.uint64)
    out: list = [None] * len(patterns)
    by_len: dict = {}
    for i, pt in enumerate(patterns):
        pc = lut[np.frombuffer(pt, np.uint8)]
        if len(pt) == 0 or (pc > 3).any() or len(pt) > len(text):
            out[i] = np.zeros(0, np.int64)
        else:
            by_len.setdefault(len(pt), []).append(i)
    for m, idx in by_len.items():
        mk = min(m, 32)
        keys = _window_keys(codes, mk)
        pk = np.concatenate([_window_keys(
            lut[np.frombuffer(patterns[i][:mk], np.uint8)].astype(np.uint64),
            mk) for i in idx])
        uk, inv = np.unique(pk, return_inverse=True)
        slot = np.clip(np.searchsorted(uk, keys), 0, len(uk) - 1)
        pos = np.nonzero(uk[slot] == keys)[0]
        order = np.argsort(slot[pos], kind="stable")
        groups = np.split(pos[order], np.searchsorted(
            slot[pos][order], np.arange(1, len(uk))))
        for i, u in zip(idx, inv):
            cand = groups[u]
            if m > mk:
                cand = [c for c in cand if text[c:c + m] == patterns[i]]
            out[i] = np.asarray(cand, np.int64)
    return out


def dna_patterns(text: bytes, lengths, count: int, seed: int = 1):
    """``count`` patterns per length: half sampled from the text, half
    absent (random ACGT strings, with one ``N`` when the length is short
    enough that every ACGT string occurs)."""
    # a PCG64 stream: the texts come from MT19937 streams, and the same
    # seed there would reproduce text as "absent" patterns
    rng = np.random.default_rng(seed)
    pats = []
    for m in lengths:
        for _ in range(count // 2):
            st = int(rng.integers(0, len(text) - m + 1))
            pats.append(text[st:st + m])
        for _ in range(count - count // 2):
            p = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, m))
            if 4 ** m <= 16 * len(text):
                p[int(rng.integers(0, m))] = ord("N")
            pats.append(bytes(p))
    return pats


def phase_desa(mesh, n: int, count: int = 1024,
               lengths=(8, 20, 64)) -> dict:
    """DESA through ``build_desa`` with both top-level indexes;
    ``bulk_locate`` ranges equal an exact occurrence scan of the text."""
    from psac_tpu.models.desa import build_desa

    text = _dna("random", n, 42)
    sa_ref, _ = _native_oracle(("random", n, 42), text)
    pats = dna_patterns(text, lengths, count)
    t0 = time.perf_counter()
    want = occurrences(text, pats)
    log(f"occurrence scan of {len(pats)} patterns over n={n}: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    out = {}
    for tli in ("tllt", "tldt"):
        desa, first, best = _timed(
            lambda: build_desa(text, mesh=mesh, tli=tli))
        _report(f"DESA build ({tli}) n={n}", first, best)
        for m in lengths:
            grp = [p for p in pats if len(p) == m]
            ranges, qfirst, qbest = _timed(lambda: desa.bulk_locate(grp))
            base = pats.index(grp[0])
            hits = 0
            for j, (lo, hi) in enumerate(ranges):
                got = np.sort(sa_ref[lo:hi])
                _gate(np.array_equal(got, want[base + j]),
                      f"DESA({tli}) range mismatch for pattern {grp[j]!r}")
                hits += hi > lo
            _report(f"DESA bulk_locate ({tli}) {len(grp)} patterns of length "
                    f"{m} ({hits} present)", qfirst, qbest,
                    f"; {len(grp) / qbest:.0f} patterns/s; OK (ranges equal "
                    "the occurrence scan)")
            out[(tli, m)] = qbest
        del desa
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded phases on a four-device mesh")
    args = ap.parse_args(argv)

    import jax

    import psac_tpu
    from psac_tpu.parallel.mesh import make_mesh
    from psac_tpu.utils.device import card_line, require_gpu

    dev = require_gpu()
    print(card_line(), flush=True)  # name, power limit: one line per card
    log(f"device_kind: {dev['kind']}; devices: {dev['count']}; "
        f"jax {jax.__version__}")
    psac_tpu.enable_compile_cache()
    log(f"compile cache: {psac_tpu.compile_cache_dir()}")
    t_all = time.perf_counter()
    if args.four_cards:
        if dev["count"] < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                             f"{dev['count']}")
        mesh = make_mesh(4)
        phase_sa(mesh, 1 << 27)
        phase_st(mesh, 1 << 20, 1 << 24)
    else:
        mesh = make_mesh(1)
        phase_sa(mesh, 1 << 26, show_program=True)
        phase_sa(mesh, 1 << 24, kind="repetitive", seed=0)
        phase_sa(mesh, 1 << 24, kind="repetitive", seed=0, force_int64=True)
        phase_st(mesh, 1 << 20, 1 << 24)
        phase_gsa(mesh, 256, 1024, 4096, 4096)
        phase_desa(mesh, 1 << 26)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
