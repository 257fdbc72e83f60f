"""ANSV: sequential oracle vs brute force; distributed vs oracle.

Mirrors the reference's test matrix (test/test_ansv.cpp: all type combos x
several input shapes x sizes), with equal-heavy inputs to stress the
furthest_eq run semantics.
"""

import numpy as np
import pytest

from psac_tpu.ops.ansv import FURTHEST_EQ, NEAREST_EQ, NEAREST_SM, NONSV, ansv_seq

TYPES = [NEAREST_SM, NEAREST_EQ, FURTHEST_EQ]


def brute_left(a, typ):
    n = len(a)
    out = np.full(n, NONSV, np.int64)
    for i in range(n):
        if typ == NEAREST_SM:
            cand = [j for j in range(i) if a[j] < a[i]]
            if cand:
                out[i] = cand[-1]
        elif typ == NEAREST_EQ:
            cand = [j for j in range(i) if a[j] <= a[i]]
            if cand:
                out[i] = cand[-1]
        else:  # FURTHEST_EQ
            visible = [j for j in range(i)
                       if (min(a[j + 1:i], default=a[j]) >= a[j]) and a[j] <= a[i]]
            if visible:
                vmax = max(a[j] for j in visible)
                out[i] = min(j for j in visible if a[j] == vmax)
    return out


def inputs():
    rng = np.random.RandomState(3)
    yield "tiny", np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], np.int32)
    yield "equal-heavy", rng.randint(0, 4, size=200).astype(np.int32)
    yield "uniform", rng.randint(0, 10**6, size=300).astype(np.int32)
    yield "bitonic", np.concatenate([np.arange(100), np.arange(100)[::-1]]).astype(np.int32)
    yield "const", np.full(64, 7, np.int32)


@pytest.mark.parametrize("typ", TYPES)
def test_oracle_vs_brute(typ):
    for name, a in inputs():
        want_l = brute_left(a, typ)
        want_r = brute_left(a[::-1], typ)
        n = len(a)
        want_r = np.where(want_r == NONSV, NONSV, n - 1 - want_r)[::-1]
        got_l, got_r = ansv_seq(a, typ, typ)
        np.testing.assert_array_equal(got_l, want_l, err_msg=f"left {name}")
        np.testing.assert_array_equal(got_r, want_r, err_msg=f"right {name}")


@pytest.mark.parametrize("lt", TYPES)
@pytest.mark.parametrize("rt", TYPES)
def test_dist_vs_oracle_small(mesh8, lt, rt):
    from psac_tpu.parallel.ansv import ansv
    for name, a in inputs():
        n = len(a)
        want_l, want_r = ansv_seq(a, lt, rt, nonsv=n)
        got_l, got_r = ansv(a, lt, rt, mesh=mesh8)
        np.testing.assert_array_equal(got_l, want_l, err_msg=f"left {name}")
        np.testing.assert_array_equal(got_r, want_r, err_msg=f"right {name}")


@pytest.mark.parametrize("n", [13, 137, 1000, 26666])
def test_dist_vs_oracle_sizes(mesh8, n):
    from psac_tpu.parallel.ansv import ansv
    rng = np.random.RandomState(n)
    for a in [rng.randint(0, 5, size=n).astype(np.int32),
              rng.randint(0, 10**7, size=n).astype(np.int32)]:
        want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=n)
        got_l, got_r = ansv(a, FURTHEST_EQ, NEAREST_SM, mesh=mesh8)
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_r, want_r)


def test_furthest_eq_is_canonical(mesh8):
    """The reference checker's property: a match's own left match is strictly
    smaller (test/test_ansv.cpp:85-88) — matches are run-leftmost."""
    rng = np.random.RandomState(7)
    a = rng.randint(0, 6, size=500).astype(np.int32)
    n = len(a)
    left, _ = ansv_seq(a, FURTHEST_EQ, FURTHEST_EQ, nonsv=n)
    for i in range(n):
        s = left[i]
        if s < n and left[s] < n:
            assert a[left[s]] < a[s]


@pytest.mark.parametrize("lt", TYPES)
@pytest.mark.parametrize("rt", TYPES)
def test_dist_vs_oracle_single_shard(mesh1, lt, rt):
    """p==1 single-shard semantics (the default ``block`` engine)."""
    from psac_tpu.parallel.ansv import ansv
    for name, a in inputs():
        n = len(a)
        want_l, want_r = ansv_seq(a, lt, rt, nonsv=n)
        got_l, got_r = ansv(a, lt, rt, mesh=mesh1)
        np.testing.assert_array_equal(got_l, want_l, err_msg=f"left {name}")
        np.testing.assert_array_equal(got_r, want_r, err_msg=f"right {name}")


@pytest.mark.parametrize("typ", TYPES)
def test_hierarchical_walk_chunked(typ, monkeypatch):
    """The lax.map-chunked hierarchical walks must agree with the oracle
    when the query count spans multiple chunks (chunk size shrunk here;
    production chunks are 512K)."""
    import psac_tpu.ops.walk as walk

    monkeypatch.setattr(walk, "_QCHUNK", 64)
    rng = np.random.RandomState(5)
    a = rng.randint(0, 6, size=1000).astype(np.int32)
    import jax.numpy as jnp
    levels = walk.build_levels(jnp.asarray(a))
    n = len(a)
    starts = jnp.arange(n, dtype=jnp.int32)
    v = jnp.asarray(a)
    strict = typ == NEAREST_SM
    got = np.asarray(walk.levels_prev_lt(levels, starts, v, strict=strict))
    want = np.full(n, -1, np.int64)
    for i in range(n):
        for j in range(i - 1, -1, -1):
            if (a[j] < a[i]) if strict else (a[j] <= a[i]):
                want[i] = j
                break
    np.testing.assert_array_equal(got, want)
    # next_leq: first j >= start with a[j] <= v
    got2 = np.asarray(walk.levels_next_leq(levels, starts, v))
    for i in range(n):
        w = n
        for j in range(i, n):
            if a[j] <= a[i]:
                w = j
                break
        assert got2[i] == w or (w == n and got2[i] >= n), (i, got2[i], w)


@pytest.mark.parametrize("typ", TYPES)
def test_block_engine_vs_oracle(typ):
    """The blocked vectorized engine (ops/bansv) must be oracle-exact on
    shapes that cross its block (256) and superblock (65536) boundaries
    and on degenerate inputs (plateaus, monotone, sawtooth)."""
    import jax.numpy as jnp

    from psac_tpu.ops.bansv import nsv_left

    rng = np.random.RandomState(11)
    cases = []
    for n in (1, 255, 257, 1000, 66000):
        cases += [rng.randint(0, 5, n).astype(np.int32),
                  np.full(n, 7, np.int32),
                  np.arange(n, dtype=np.int32),
                  (n - np.arange(n)).astype(np.int32)]
        saw = np.arange(n, dtype=np.int32)
        saw[::2] = 10**6 - saw[::2]
        cases.append(saw)
    for a in cases:
        want, _ = ansv_seq(a, typ, typ)
        idx, val = nsv_left(jnp.asarray(a), typ)
        got = np.asarray(idx).astype(np.int64)
        got[got < 0] = NONSV
        np.testing.assert_array_equal(got, want)
        m = np.asarray(idx) >= 0
        np.testing.assert_array_equal(np.asarray(val)[m],
                                      a[np.asarray(idx)[m]])


@pytest.mark.parametrize("typ", TYPES)
def test_block_engine_small_blocks(typ, monkeypatch):
    """Shrunken block size forces the superblock + distant-block resolve
    stages (incl. multiple while_loop chunks) on small inputs."""
    import jax.numpy as jnp

    import psac_tpu.ops.bansv as bansv

    monkeypatch.setattr(bansv, "B", 4)
    monkeypatch.setattr(bansv, "_BC", 8)
    monkeypatch.setattr(bansv, "_QMIN", 8)
    rng = np.random.RandomState(12)
    for n in (3, 16, 17, 64, 65, 257, 1000):
        for a in (rng.randint(0, 4, n).astype(np.int32),
                  np.full(n, 3, np.int32),
                  rng.randint(0, 1000, n).astype(np.int32)):
            want, _ = ansv_seq(a, typ, typ)
            idx, _val = bansv.nsv_left(jnp.asarray(a), typ)
            got = np.asarray(idx).astype(np.int64)
            got[got < 0] = NONSV
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lt,rt", [(NEAREST_SM, NEAREST_SM),
                                   (FURTHEST_EQ, NEAREST_EQ)])
def test_wide_values(lt, rt):
    """Values beyond int32 must not be silently truncated (the reference's
    ansv is templated over T, include/ansv.hpp:2042-2051): the public
    ansv() runs them through the SAME distributed pipeline at int64 under a
    scoped x64 context (no single-shard serial fallback)."""
    from psac_tpu.parallel.ansv import ansv
    from psac_tpu.parallel.mesh import make_mesh, num_shards, padded_size

    rng = np.random.RandomState(9)
    a = (rng.randint(0, 2**31, size=333).astype(np.int64) << 10) + 5
    a[::7] = a[3]  # equal runs for the *_eq semantics
    cases = [a, np.full(50, np.int64(1) << 35),
             np.array([2**33, 5, 2**34, 2**34, 7, 2**33], np.int64)]
    p = num_shards(make_mesh())
    for arr in cases:
        n = len(arr)
        s = padded_size(n, p) // p
        want_l, want_r = ansv_seq(arr, lt, rt, nonsv=n)
        got_l, got_r = ansv(arr, lt, rt)
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_r, want_r)
        (lrank, lloc, lv), (rrank, rloc, rv) = ansv(arr, lt, rt,
                                                    indexing="local")
        for want, rank, loc, val in ((want_l, lrank, lloc, lv),
                                     (want_r, rrank, rloc, rv)):
            miss = want == n
            np.testing.assert_array_equal(rank[miss], -1)
            np.testing.assert_array_equal(val[miss], 0)
            np.testing.assert_array_equal(rank[~miss] * s + loc[~miss],
                                          want[~miss])
            np.testing.assert_array_equal(val[~miss], arr[want[~miss]])


@pytest.mark.parametrize("lt,rt", [(NEAREST_SM, NEAREST_SM),
                                   (FURTHEST_EQ, NEAREST_SM)])
def test_local_indexing(mesh8, lt, rt):
    """``indexing='local'`` (reference ``local_indexing``,
    include/ansv_common.hpp:20-25) decomposes every global match into
    (rank, local_idx, value): rank*s + local_idx == the global match, and
    the value equals the array element there — the match is readable with
    no further communication, like the reference's lr_mins entries."""
    from psac_tpu.parallel.ansv import ansv
    from psac_tpu.parallel.mesh import num_shards, padded_size

    rng = np.random.RandomState(3)
    a = rng.randint(0, 8, size=777).astype(np.int32)
    n = len(a)
    s = padded_size(n, num_shards(mesh8)) // num_shards(mesh8)
    want_l, want_r = ansv(a, lt, rt, mesh=mesh8)
    (lrank, lloc, lv), (rrank, rloc, rv) = ansv(a, lt, rt, mesh=mesh8,
                                                indexing="local")
    for want, rank, loc, val in ((want_l, lrank, lloc, lv),
                                 (want_r, rrank, rloc, rv)):
        miss = want == n
        np.testing.assert_array_equal(rank[miss], -1)
        np.testing.assert_array_equal(loc[miss], n)
        np.testing.assert_array_equal(val[miss], 0)
        np.testing.assert_array_equal(rank[~miss] * s + loc[~miss],
                                      want[~miss])
        np.testing.assert_array_equal(val[~miss], a[want[~miss]])


def _tile_edge_cases():
    """Adversarial arrays around 512-element tile boundaries (runs that
    straddle tile edges, all-equal tiles, two-level runs)."""
    rng = np.random.RandomState(11)
    T = 512
    cases = {
        "random_small_alpha": rng.randint(0, 7, 4096).astype(np.int32),
        "random_wide": rng.randint(0, 100000, 2048).astype(np.int32),
        "all_equal": np.full(2048, 5, np.int32),
        "tile_edge_runs": np.tile(
            np.repeat(np.arange(8, dtype=np.int32), T // 2)[:T], 8)[:4096],
        "sawtooth": (np.arange(4096, dtype=np.int32) % 37),
        "two_level_runs": np.where(np.arange(4096) % T < 3, 1, 2
                                   ).astype(np.int32),
    }
    # runs straddling tile edges exactly: value drops 1 position past each
    # boundary so the run head is in the previous tile
    x = np.full(4096, 9, np.int32)
    x[T + 1::T] = 4
    cases["straddle"] = x
    return cases


def _real_lcp_cases(seed):
    """Run-heavy arrays and the LCP array of a repetitive text."""
    from psac_tpu.ops.oracle import lcp_kasai, suffix_array_np

    rng = np.random.RandomState(seed + 50)
    cases = [rng.randint(0, 3, 4096).astype(np.int32),
             np.repeat(rng.randint(0, 5, 64), 64).astype(np.int32)[:4096]]
    text = bytes(rng.randint(97, 100, 600).astype(np.uint8)) * 8
    sa = suffix_array_np(text)
    cases.append(lcp_kasai(text, sa).astype(np.int32))
    return cases


def _check_st_pass(a, mesh):
    """The suffix tree's ANSV pass (left furthest_eq, right nearest_sm)
    equals the sequential oracle, indices and (local indexing) values."""
    from psac_tpu.parallel.ansv import ansv

    n = len(a)
    want_l, want_r = ansv_seq(a, FURTHEST_EQ, NEAREST_SM, nonsv=n)
    got_l, got_r = ansv(a, FURTHEST_EQ, NEAREST_SM, mesh=mesh)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_r, want_r)
    (_, _, lv), (_, _, rv) = ansv(a, FURTHEST_EQ, NEAREST_SM, mesh=mesh,
                                  indexing="local")
    for want, val in ((want_l, lv), (want_r, rv)):
        has = want != n
        np.testing.assert_array_equal(val[has], a[want[has]])


@pytest.mark.parametrize("mesh_name", ["mesh1", "mesh8"])
@pytest.mark.parametrize("name", sorted(_tile_edge_cases()))
def test_st_pass_tile_edges(name, mesh_name, request):
    """Tile-edge adversarial arrays through the public ``ansv`` on one shard
    (block engine) and eight shards (routed walk engine)."""
    _check_st_pass(_tile_edge_cases()[name], request.getfixturevalue(mesh_name))


@pytest.mark.parametrize("mesh_name", ["mesh1", "mesh8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_st_pass_randomized(seed, mesh_name, request):
    """Randomized run-heavy arrays and a real LCP array (repetitive text —
    long equal runs) on both engines."""
    mesh = request.getfixturevalue(mesh_name)
    for a in _real_lcp_cases(seed):
        _check_st_pass(a, mesh)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "other"])
def test_engine_defaults_to_block(backend, monkeypatch):
    """The single-shard engine does not depend on the backend."""
    import jax

    from psac_tpu.parallel import ansv as pansv

    monkeypatch.delenv("PSAC_NSV", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert pansv._engine() == "block"


@pytest.mark.parametrize("name", ["hybrid", "spine", "scan", "bogus"])
def test_engine_rejects_unknown(name, monkeypatch):
    from psac_tpu.parallel import ansv as pansv

    monkeypatch.setenv("PSAC_NSV", name)
    with pytest.raises(ValueError, match="PSAC_NSV"):
        pansv._engine()


def test_walk_engine_single_shard(monkeypatch, mesh1):
    """PSAC_NSV=walk runs the single-shard pass on the hierarchical walks
    and still answers like the oracle."""
    from psac_tpu.parallel import ansv as pansv

    monkeypatch.setenv("PSAC_NSV", "walk")
    pansv._JIT_CACHE.clear()
    try:
        rng = np.random.RandomState(13)
        for a in (rng.randint(0, 9, 2048).astype(np.int32),
                  np.arange(2048, 0, -1).astype(np.int32)):
            _check_st_pass(a, mesh1)
    finally:
        pansv._JIT_CACHE.clear()
