"""Unit tests of the collectives layer on an 8-device CPU mesh vs NumPy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from psac_tpu.parallel.collectives import (
    global_cummax, global_shift_left, global_shift_left_dyn,
    halo_from_left, halo_from_right)
from psac_tpu.parallel.route import route_apply, route_scatter
from psac_tpu.parallel.sort import dist_sort_local, scatter_by_index_local
from psac_tpu.parallel.mesh import AXIS, block_sharding


def put(mesh, *arrays):
    outs = tuple(jax.device_put(a, block_sharding(mesh)) for a in arrays)
    return outs[0] if len(outs) == 1 else outs


def test_global_shift(mesh8):
    N, p = 64, 8
    s = N // p
    x = np.arange(100, 100 + N).astype(np.int32)
    xd = put(mesh8, x)
    for d in [0, 1, 3, 7, 8, 9, 15, 16, 17, 31, 40, 63, 64, 100]:
        q = min(d // s, p)
        f = jax.jit(jax.shard_map(
            functools.partial(global_shift_left, d=jnp.int32(d), q=q, p=p),
            mesh=mesh8, in_specs=P(AXIS), out_specs=P(AXIS)))
        got = np.asarray(f(xd))
        want = np.zeros(N, np.int32)
        if d < N:
            want[:N - d] = x[d:]
        np.testing.assert_array_equal(got, want, err_msg=f"d={d}")


@pytest.mark.parametrize("p,meshname", [(8, "mesh8"), (1, "mesh1")])
def test_global_shift_dyn(request, p, meshname):
    """Traced-distance shift (the fused dense loop's ladder) vs NumPy."""
    mesh = request.getfixturevalue(meshname)
    N = 64
    s = N // p
    x = np.arange(100, 100 + N).astype(np.int32)
    xd = put(mesh, x)
    f = jax.jit(jax.shard_map(
        functools.partial(global_shift_left_dyn, p=p),
        mesh=mesh, in_specs=(P(AXIS), P()), out_specs=P(AXIS)))
    for d in [0, 1, 3, 7, 8, 9, 15, 16, 17, 24, 31, 40, 56, 63, 64, 100]:
        got = np.asarray(f(xd, jnp.int32(d)))
        want = np.zeros(N, np.int32)
        if d < N:
            want[:N - d] = x[d:]
        np.testing.assert_array_equal(got, want, err_msg=f"p={p} d={d}")


def test_global_cummax(mesh8):
    N, p = 64, 8
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, size=N).astype(np.int32)
    f = jax.jit(jax.shard_map(functools.partial(global_cummax, p=p),
                              mesh=mesh8, in_specs=P(AXIS), out_specs=P(AXIS)))
    np.testing.assert_array_equal(np.asarray(f(put(mesh8, x))), np.maximum.accumulate(x))


def test_halos(mesh8):
    N, p = 32, 8
    x = np.arange(N).astype(np.int32)
    xd = put(mesh8, x)
    fr = jax.jit(jax.shard_map(functools.partial(halo_from_right, count=2, p=p),
                               mesh=mesh8, in_specs=P(AXIS), out_specs=P(AXIS)))
    got = np.asarray(fr(xd)).reshape(p, 2)
    want = np.stack([x.reshape(p, -1)[i + 1, :2] if i < p - 1 else np.zeros(2, np.int32) for i in range(p)])
    np.testing.assert_array_equal(got, want)
    fl = jax.jit(jax.shard_map(functools.partial(halo_from_left, count=1, p=p, fill=-5),
                               mesh=mesh8, in_specs=P(AXIS), out_specs=P(AXIS)))
    got = np.asarray(fl(xd)).reshape(p)
    want = np.array([-5] + [x.reshape(p, -1)[i, -1] for i in range(p - 1)], np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("hi", [10, 100000])
def test_dist_sort(mesh8, n_keys, hi):
    N, p = 128, 8
    rng = np.random.RandomState(42)
    ks = [rng.randint(0, hi, size=N).astype(np.int32) for _ in range(n_keys)]
    val = np.arange(N).astype(np.int32)
    arrays = (*ks, val)

    def inner(*xs):
        return dist_sort_local(tuple(xs), num_keys=n_keys, p=p)

    f = jax.jit(jax.shard_map(inner, mesh=mesh8,
                              in_specs=(P(AXIS),) * len(arrays), out_specs=(P(AXIS),) * len(arrays)))
    out = [np.asarray(o) for o in f(*put(mesh8, *arrays))]
    order = np.lexsort(tuple(reversed(ks)))
    for i in range(n_keys):
        np.testing.assert_array_equal(out[i], ks[i][order])
    got_rows = sorted(zip(*[o.tolist() for o in out]))
    want_rows = sorted(zip(*[a.tolist() for a in arrays]))
    assert got_rows == want_rows


def test_scatter_by_index(mesh8):
    N, p = 64, 8
    rng = np.random.RandomState(3)
    perm = rng.permutation(N).astype(np.int32)
    vals = rng.randint(0, 1000, N).astype(np.int32)

    def inner(d, v):
        return scatter_by_index_local(d, (v,), p)[0]

    f = jax.jit(jax.shard_map(inner, mesh=mesh8, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS)))
    got = np.asarray(f(*put(mesh8, perm, vals)))
    want = np.empty(N, np.int32)
    want[perm] = vals
    np.testing.assert_array_equal(got, want)


def test_route_apply_echo(mesh8):
    """Ship each record to a shard, owner tags it with its shard id, round trip."""
    N, p = 64, 8
    rng = np.random.RandomState(7)
    payload = rng.randint(0, 100, N).astype(np.int32)
    dest = rng.randint(0, p, N).astype(np.int32)

    def inner(pay, dst):
        def answer(recv, valid):
            (v,) = recv
            me = jax.lax.axis_index(AXIS).astype(jnp.int32)
            return (jnp.where(valid, v * 10 + me, -1),)
        return route_apply((pay,), dst, answer, (jnp.int32,), p)[0]

    f = jax.jit(jax.shard_map(inner, mesh=mesh8, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS)))
    got = np.asarray(f(*put(mesh8, payload, dest)))
    np.testing.assert_array_equal(got, payload * 10 + dest)


def test_route_scatter(mesh8):
    N, p = 64, 8
    s = N // p
    rng = np.random.RandomState(11)
    target = np.zeros(N, np.int32)
    dest_idx = rng.choice(N, size=16, replace=False).astype(np.int32)
    vals = (100 + np.arange(16)).astype(np.int32)
    valid = np.ones(16, bool)
    valid[3] = False

    def inner(tgt, di, v, vd):
        return route_scatter(di, (v,), (tgt,), vd, s, p)[0]

    f = jax.jit(jax.shard_map(inner, mesh=mesh8,
                              in_specs=(P(AXIS),) * 4, out_specs=P(AXIS)))
    got = np.asarray(f(*put(mesh8, target, dest_idx, vals, valid)))
    want = target.copy()
    want[dest_idx[valid]] = vals[valid]
    np.testing.assert_array_equal(got, want)


def test_bulk_rmq_capacity_overflow_retry(mesh8):
    """A deliberately skewed query set (every range lands on shard 0) must
    overflow a tight per-destination capacity and report it, and the
    cap=None retry (capacity = q, the reference's O(m) ``bulk_rma`` bound)
    must answer exactly (no unbounded O(p*q) buffers on the per-iteration
    resolve path without an overflow escape hatch)."""
    from psac_tpu.ops.rmq import build_local_rmq
    from psac_tpu.parallel.par_rmq import bulk_rmq_local
    from psac_tpu.parallel.collectives import shard_minima

    N, p = 512, 8
    s = N // p
    rng = np.random.RandomState(13)
    x = rng.randint(0, 1000, N).astype(np.int32)
    q = 64  # per shard; ALL ranges inside shard 0 -> 8*64 queries at dest 0
    ls = rng.randint(0, s // 2, q).astype(np.int32)
    rs = (ls + rng.randint(0, s // 2, q)).astype(np.int32)

    def inner(x_l, l, r, cap):
        rmq = build_local_rmq(x_l, with_small=False)
        sm = shard_minima(x_l, p)
        valid = jnp.ones((q,), bool)
        return bulk_rmq_local(rmq, sm, l, r, valid, s, p, cap=cap,
                              with_overflow=True)

    lrep = np.tile(ls, (p, 1)).reshape(-1)
    rrep = np.tile(rs, (p, 1)).reshape(-1)
    for cap, expect_ovf in ((8, True), (None, False)):
        f = jax.jit(jax.shard_map(
            functools.partial(inner, cap=cap), mesh=mesh8,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)), out_specs=(P(AXIS), P())))
        mins, ovf = f(*put(mesh8, x, lrep, rrep))
        if expect_ovf:
            assert int(ovf) > 0
        else:
            assert int(ovf) == 0
            want = np.array([x[l:r + 1].min() for l, r in zip(ls, rs)])
            got = np.asarray(mins).reshape(p, q)
            for row in got:
                np.testing.assert_array_equal(row, want)


def test_route_apply_chunked_full_pass(mesh8):
    """The cap=None (never-overflow) pass routes in p chunks so worst-case
    exchange buffers stay O(m + p*chunk) ~ 2m rows instead of O(p*m)
    (instead of a 1 GB-per-operand spike at 16M x p=16).  Fully skewed
    destinations (every record to shard 0) must still answer exactly."""
    import psac_tpu.parallel.route as route_mod

    N, p = 256, 8
    rng = np.random.RandomState(13)
    payload = rng.randint(0, 1000, N).astype(np.int32)
    dest = np.zeros(N, np.int32)  # worst-case skew
    skip = np.zeros(N, bool)
    skip[::17] = True

    def inner(pay, dst, sk):
        def answer(recv, valid):
            (v,) = recv
            me = jax.lax.axis_index(AXIS).astype(jnp.int32)
            return (jnp.where(valid, v * 10 + me, -1),)
        return route_apply((pay,), dst, answer, (jnp.int32,), p,
                           cap=None, skip=sk)[0]

    route_mod.LAST_CHUNKED_ROUTE.clear()
    f = jax.jit(jax.shard_map(inner, mesh=mesh8,
                              in_specs=(P(AXIS),) * 3, out_specs=P(AXIS)))
    got = np.asarray(f(*put(mesh8, payload, dest, skip)))
    want = np.where(skip, 0, payload * 10)  # dest 0 everywhere; skipped -> 0
    np.testing.assert_array_equal(got, want)
    # the bounded-buffer guarantee: per-exchange rows ~ m (not p*m)
    stats = route_mod.LAST_CHUNKED_ROUTE
    m_local = N // p
    assert stats["m"] == m_local
    assert stats["buf_rows"] <= m_local + p, stats
