"""DESA: bulk_locate ranges vs naive occurrence scan (reference test_desa.cpp)."""

import numpy as np
import pytest

from psac_tpu.ops.alphabet import rand_dna
from psac_tpu.ops.oracle import suffix_array_np


def occurrences(text: bytes, pat: bytes):
    out, start = [], 0
    while True:
        i = text.find(pat, start)
        if i < 0:
            return sorted(out)
        out.append(i)
        start = i + 1


def check_patterns(desa, text: bytes, sa, patterns):
    ranges = desa.bulk_locate(patterns)
    for pat, (l, r) in zip(patterns, ranges):
        got = sorted(sa[l:r].tolist())
        want = occurrences(text, pat)
        assert got == want, (pat, l, r, got[:10], want[:10])


def test_desa_mississippi(mesh8):
    from psac_tpu.models.desa import build_desa
    text = b"mississippi"
    desa = build_desa(text, mesh=mesh8, tli_bits=6)
    sa = suffix_array_np(text)
    pats = [b"i", b"iss", b"ssi", b"mississippi", b"ppi", b"xyz", b"issb",
            b"s", b"sis", b"m", b"pp", b"missx"]
    check_patterns(desa, text, sa, pats)


@pytest.mark.parametrize("n", [1000, 13337])
def test_desa_dna(mesh8, n):
    from psac_tpu.models.desa import build_desa
    text = rand_dna(n, seed=n)
    desa = build_desa(text, mesh=mesh8)
    sa = suffix_array_np(text)
    rng = np.random.RandomState(5)
    pats = []
    for ln in [1, 2, 4, 5, 6, 9, 17, 40]:
        for _ in range(6):
            st = rng.randint(0, n - ln)
            pats.append(text[st:st + ln])
    # absent / mutated patterns
    pats += [b"ACGTACGTACGTACGTACGTX"[:12].replace(b"X", b"A") + b"TTTTTTTTT",
             b"GGGGGGGGGGGGGGGGGGGGGGGG", b"A" * 30]
    check_patterns(desa, text, sa, pats)


def test_desa_repeats(mesh8):
    from psac_tpu.models.desa import build_desa
    text = b"abab" * 250
    desa = build_desa(text, mesh=mesh8, tli_bits=8)
    sa = suffix_array_np(text)
    pats = [b"ab", b"ba", b"abab", b"aa", b"bab" * 20, b"ab" * 100]
    check_patterns(desa, text, sa, pats)


@pytest.mark.parametrize("n", [1000, 9000])
def test_desa_tldt(mesh8, n):
    from psac_tpu.models.desa import build_desa
    text = rand_dna(n, seed=n + 1)
    desa = build_desa(text, mesh=mesh8, tli="tldt", maxsize=8)
    assert desa.tli == "tldt" and desa.samp["m"] >= 2
    sa = suffix_array_np(text)
    rng = np.random.RandomState(2)
    pats = []
    for ln in [1, 2, 3, 5, 9, 20]:
        for _ in range(5):
            st = rng.randint(0, n - ln)
            pats.append(text[st:st + ln])
    pats += [b"GGGGGGGGGGGGGGGGGG", b"A", b"T" * 25]
    check_patterns(desa, text, sa, pats)


def test_desa_tldt_repeats(mesh8):
    from psac_tpu.models.desa import build_desa
    text = b"abab" * 200 + b"bba" * 100
    desa = build_desa(text, mesh=mesh8, tli="tldt", maxsize=4)
    sa = suffix_array_np(text)
    check_patterns(desa, text, sa,
                   [b"ab", b"ba", b"bb", b"abab" * 10, b"bba", b"aa", b"b"])


def test_locate_possible(mesh8):
    """Reference ``locate_possible`` parity (include/desa.hpp:531-555): the
    unverified candidate range equals the exact range for occurring patterns
    and contains the blind-search candidate for absent ones."""
    from psac_tpu.models.desa import build_desa
    text = rand_dna(2000, seed=17)
    desa = build_desa(text, mesh=mesh8)
    sa = suffix_array_np(text)
    present = [text[100:108], text[5:6], text[900:925]]
    for pat in present:
        l, r = desa.locate_possible(pat)
        el, er = desa.locate(pat)
        assert (l, r) == (el, er)
        assert sorted(sa[l:r].tolist()) == occurrences(text, pat)
    # absent pattern: possible may be a spurious nonempty range, but the
    # verified locate must be empty
    absent = b"ACGT" * 3 + b"AAAAAAAAAAAAAAAA"
    el, er = desa.locate(absent)
    assert el == er
    pl, pr = desa.locate_possible(absent)
    assert pr - pl >= 0  # well-formed


def test_read_desa_tli_passthrough(mesh8, tmp_path):
    """read_desa must preserve the requested TLI kind (tldt indexes were
    silently reloading as tllt)."""
    from psac_tpu.models.desa import build_desa, read_desa, write_desa
    text = rand_dna(1500, seed=23)
    desa = build_desa(text, mesh=mesh8, tli="tldt", maxsize=8)
    prefix = str(tmp_path / "idx")
    write_desa(desa, prefix)
    loaded = read_desa(text, prefix, mesh=mesh8, tli="tldt", maxsize=8)
    assert loaded.tli == "tldt"
    sa = suffix_array_np(text)
    pats = [text[7:19], text[100:103], b"GGGGGGGGGGGGGGGGGG"]
    check_patterns(loaded, text, sa, pats)


def test_locate_possible_tldt(mesh8):
    """locate_possible with the TLDT top-level index (unverified
    semantics)."""
    from psac_tpu.models.desa import build_desa
    text = rand_dna(1800, seed=31)
    desa = build_desa(text, mesh=mesh8, tli="tldt", maxsize=8)
    sa = suffix_array_np(text)
    for pat in (text[50:62], text[900:905]):
        l, r = desa.locate_possible(pat)
        el, er = desa.locate(pat)
        assert (l, r) == (el, er)
        assert sorted(sa[l:r].tolist()) == occurrences(text, pat)


def test_desa_force_int64(mesh8):
    """The int64-indexed DESA (auto at n >= 2^30, reference's index_t-
    templated dist_desa, include/desa.hpp:222-248) must answer bit-
    identically to the int32 build on the same text."""
    import dataclasses

    import psac_tpu.config as cfg
    from psac_tpu.models.desa import build_desa

    text = rand_dna(1700, seed=41)
    sa = suffix_array_np(text)
    rng = np.random.RandomState(6)
    pats = [text[rng.randint(0, 1600):][:ln] for ln in (1, 3, 7, 12, 25)
            for _ in (0, 1)] + [b"GGGGGGGGGGGGGGGGGGGG"]
    d32 = build_desa(text, mesh=mesh8)
    want = d32.bulk_locate(pats)
    conf64 = dataclasses.replace(cfg.DEFAULT, force_int64=True,
                                 construct_lc=True)
    d64 = build_desa(text, mesh=mesh8, config=conf64)
    import jax.numpy as jnp
    assert d64.idt == jnp.int64 and jnp.dtype(d64.sa.dtype) == jnp.int64
    got = d64.bulk_locate(pats)
    assert [tuple(x) for x in got] == [tuple(x) for x in want]
    check_patterns(d64, text, sa, pats)


def test_desa_tldt_int64_2pow31_shapes(mesh8):
    """The tldt sampling mask (distributed ANSV over the LCP) must trace at
    2^31 chars with int64 indexes (the reference's index-templated tldt,
    include/tldt.hpp:412-473; the former int32 gate is lifted)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from psac_tpu.models.desa import _sample_mask_count_local
    from psac_tpu.models.suffix_array import _x64_ctx
    from psac_tpu.parallel.mesh import AXIS

    N = 1 << 31
    p = 8
    s = N // p
    with _x64_ctx(jnp.int64):
        fn = jax.shard_map(
            functools.partial(_sample_mask_count_local, s=s, p=p, n=N - 5,
                              maxsize=1 << 20),
            mesh=mesh8, in_specs=(P(AXIS),), out_specs=(P(AXIS), P()))
        lcp = jax.ShapeDtypeStruct((N,), jnp.int64)
        keep, cnt = jax.eval_shape(fn, lcp)
        assert keep.shape == (N,) and keep.dtype == jnp.bool_


def test_desa_staged_build_and_distributed_io(mesh8, tmp_path):
    """``build_desa_from_file`` (per-process staged read, reference
    desa_main.cpp:64-83) must match ``build_desa`` on the same bytes;
    ``write_desa_distributed`` must produce byte-identical artifacts to
    ``write_desa``; ``read_desa_from_file`` must answer identically."""
    from psac_tpu.models.desa import (
        build_desa,
        build_desa_from_file,
        read_desa_from_file,
        write_desa,
        write_desa_distributed,
    )

    text = rand_dna(9001, seed=31)
    path = tmp_path / "corpus.bin"
    path.write_bytes(text)
    pats = [text[0:6], text[100:120], b"nope", text[5000:5007]]
    sa = suffix_array_np(text)

    idx = build_desa(text, mesh=mesh8)
    want = idx.bulk_locate(pats)
    idx2 = build_desa_from_file(str(path), mesh=mesh8)
    got = idx2.bulk_locate(pats)
    np.testing.assert_array_equal(got, want)

    write_desa(idx, str(tmp_path / "a"))
    write_desa_distributed(idx2, str(tmp_path / "b"))
    for suffix in (".sa64", ".lcp64", ".lc64", ".alpha"):
        a = (tmp_path / ("a" + suffix)).read_bytes()
        b = (tmp_path / ("b" + suffix)).read_bytes()
        assert a == b, f"distributed write differs for {suffix}"

    idx3 = read_desa_from_file(str(path), str(tmp_path / "b"), mesh=mesh8)
    got3 = idx3.bulk_locate(pats)
    np.testing.assert_array_equal(got3, want)
    check_patterns(idx3, text, sa, pats)


def test_construct_lc_config_wired(mesh8):
    """``SAConfig.construct_lc`` triggers Lc computation in
    ``construct_device`` (it was once a dead knob)."""
    import dataclasses

    from psac_tpu import config as cfg
    from psac_tpu.models.suffix_array import (
        compute_lc_device,
        construct_device,
        encode_and_shard,
    )

    text = rand_dna(2000, seed=8)
    conf = dataclasses.replace(cfg.DEFAULT, construct_lc=True)
    xs, alpha, n, N = encode_and_shard(text, mesh8)
    dsa = construct_device(xs, alpha, n, N, mesh8, conf)
    assert dsa.lc is not None
    import jax
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(dsa.lc)),
        np.asarray(jax.device_get(compute_lc_device(dsa, xs))))
    dsa0 = construct_device(xs, alpha, n, N, mesh8)
    assert dsa0.lc is None
