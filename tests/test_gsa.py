"""GSA: distributed construction vs a naive sort oracle.

Mirrors the reference's test matrix (test/test_gsa.cpp: (ab)^i repeat
families with closed-form GSA/GLCP) plus duplicate-string tie cases.
"""

import numpy as np
import pytest

from psac_tpu.ops.oracle import gsa_naive as gsa_oracle


def check(mesh, parts):
    from psac_tpu.models.gsa import build_gsa
    res = build_gsa(parts, mesh=mesh)
    want_sa, want_lcp = gsa_oracle([bytes(x) for x in parts if len(x)])
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)


def test_gsa_repeat_family(mesh8):
    # the reference's closed-form family: strings (ab)^i
    check(mesh8, [b"ab" * i for i in range(1, 12)])


def test_gsa_duplicates(mesh8):
    # identical strings: every suffix ties; exercises settled-termination
    check(mesh8, [b"banana"] * 5 + [b"ban", b"anana"])


def test_gsa_single_string_equals_sa(mesh8):
    from psac_tpu.models.gsa import build_gsa
    from psac_tpu.ops.oracle import lcp_kasai, suffix_array_np
    text = b"mississippi"
    res = build_gsa([text], mesh=mesh8)
    np.testing.assert_array_equal(res.sa, suffix_array_np(text))
    np.testing.assert_array_equal(res.lcp, lcp_kasai(text, suffix_array_np(text)))


def test_gsa_random_dna_set(mesh8):
    from psac_tpu.ops.alphabet import rand_dna
    rng = np.random.RandomState(9)
    parts = [rand_dna(int(ln), seed=int(ln) + j)
             for j, ln in enumerate(rng.randint(1, 400, size=12))]
    check(mesh8, parts)


def test_gsa_newline_flat_input(mesh8):
    from psac_tpu.models.gsa import build_gsa
    res = build_gsa(b"abc\nbca\ncab\n", mesh=mesh8)
    want_sa, want_lcp = gsa_oracle([b"abc", b"bca", b"cab"])
    np.testing.assert_array_equal(res.sa, want_sa)
    np.testing.assert_array_equal(res.lcp, want_lcp)


def test_gsa_many_tiny_strings(mesh8):
    check(mesh8, [b"a", b"b", b"a", b"ab", b"ba", b"b", b"aa"] * 3)


def gst_expected(parts):
    from psac_tpu.ops.alphabet import Alphabet
    from psac_tpu.verify.suffix_tree_oracle import gst_oracle
    flat = b"".join(parts)
    lens = np.array([len(x) for x in parts], np.int64)
    eos = np.repeat(np.cumsum(lens), lens)
    alpha = Alphabet.from_bytes(flat)
    sa, lcp = gsa_oracle(parts)
    return gst_oracle(alpha.encode(flat), sa, lcp, eos, alpha.sigma)


@pytest.mark.parametrize("parts", [
    [b"ab" * i for i in range(1, 8)],
    [b"banana", b"ananas", b"banana", b"nab"],
    [b"abc", b"bca", b"cab"],
])
def test_gst(mesh8, parts):
    from psac_tpu.models.suffix_tree import build_gst
    got = build_gst(parts, mesh=mesh8)
    np.testing.assert_array_equal(got, gst_expected(parts))


def test_gst_dna_set(mesh8):
    from psac_tpu.models.suffix_tree import build_gst
    from psac_tpu.ops.alphabet import rand_dna
    rng = np.random.RandomState(3)
    parts = [rand_dna(int(ln), seed=int(ln) + 7 * j)
             for j, ln in enumerate(rng.randint(2, 300, size=10))]
    got = build_gst(parts, mesh=mesh8)
    np.testing.assert_array_equal(got, gst_expected(parts))


def test_gsa_fused_single_shard(mesh1):
    """mesh1 takes the fused one-dispatch GSA path (init + dense while_loop
    + eos-aware two-stage tail); GSA AND GLCP must equal the oracle."""
    from psac_tpu.models.gsa import build_gsa
    from psac_tpu.ops.alphabet import rand_dna

    rng = np.random.RandomState(17)
    strings = [rand_dna(int(l), seed=300 + i)
               for i, l in enumerate(rng.randint(2, 150, 30))]
    strings += [b"abab" * 40] * 3 + [b"a" * 120, b"a" * 60]
    want_sa, want_lcp = gsa_oracle(strings)
    g1 = build_gsa(strings, mesh=mesh1)
    np.testing.assert_array_equal(g1.sa, want_sa)
    np.testing.assert_array_equal(g1.lcp, want_lcp)


def test_gsa_int64_index_build(mesh8, mesh1):
    """The GSA builder is index_t-generic like the reference's construct_ss
    (include/suffix_array.hpp:269): force_int64 runs the int64 path at a
    testable size; results must be bit-identical to the int32 build."""
    import dataclasses

    from psac_tpu import config as cfg
    from psac_tpu.models.gsa import build_gsa
    from psac_tpu.ops.alphabet import rand_dna

    rng = np.random.RandomState(23)
    strings = [rand_dna(int(l), seed=40 + i)
               for i, l in enumerate(rng.randint(2, 120, 20))]
    strings += [b"abab" * 30] * 2 + [b"a" * 90]
    conf64 = dataclasses.replace(cfg.DEFAULT, force_int64=True)
    want = build_gsa(strings, mesh=mesh8)
    for mesh in (mesh8, mesh1):
        got = build_gsa(strings, mesh=mesh, config=conf64)
        np.testing.assert_array_equal(got.sa, want.sa)
        np.testing.assert_array_equal(got.lcp, want.lcp)


def test_gsa_from_file_staged(mesh8, mesh1, tmp_path):
    """The staged file path (reference gsac -f over a distributed file,
    include/stringset.hpp:43-152) must agree with the in-memory builder:
    separator compaction, string-boundary recovery (incl. empty strings
    and a missing trailing separator), and the GSA/GLCP themselves."""
    from psac_tpu.models.gsa import build_gsa, build_gsa_from_file
    from psac_tpu.ops.alphabet import rand_dna

    rng = np.random.RandomState(31)
    parts = [rand_dna(int(l), seed=70 + i)
             for i, l in enumerate(rng.randint(1, 90, 25))]
    cases = [
        b"\n".join(parts) + b"\n",          # trailing separator
        b"\n".join(parts),                   # no trailing separator
        b"\n\n" + b"\n\n".join(parts[:9]),  # empty strings interleaved
    ]
    for fused_content in cases:
        f = tmp_path / "strings.txt"
        f.write_bytes(fused_content)
        want = build_gsa(fused_content, mesh=mesh8)
        for mesh in (mesh8, mesh1):
            got = build_gsa_from_file(str(f), mesh=mesh).materialize()
            np.testing.assert_array_equal(got.lens, want.lens)
            np.testing.assert_array_equal(got.sa, want.sa)
            np.testing.assert_array_equal(got.lcp, want.lcp)
