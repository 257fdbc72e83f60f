"""Per-host shard staging — the multi-host data path.

The reference reads per-rank file blocks via MPI-IO and keeps O(n/p)
bytes per rank end to end (``src/psac.cpp:85``,
``include/suffix_array.hpp:130-166`` ``mxx::coll_file`` /
``file_block_decompose``).  Mesh equivalent:
``jax.make_array_from_callback`` builds the block-sharded global array
from per-ADDRESSABLE-shard callbacks, so each process materializes only
its own shards' bytes (no full-n host allocation anywhere on the staging
path), and the alphabet histogram is computed on device and reduced
across the mesh instead of on a gathered host copy.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from psac_tpu.parallel.mesh import (
    AXIS,
    block_sharding,
    mesh_key,
    num_shards,
    padded_size,
)

_HIST_CACHE: dict = {}


def _staged_bytes(read_range, n: int, N: int, mesh):
    """Block-sharded (N,) uint8 array; ``read_range(lo, m)`` supplies the m
    source bytes at offset lo (only called for this process's shards)."""

    def cb(index):
        (sl,) = index
        lo = sl.start or 0
        hi = sl.stop if sl.stop is not None else N
        out = np.zeros(hi - lo, np.uint8)
        m = max(0, min(hi, n) - lo)
        if m:
            out[:m] = read_range(lo, m)
        return out

    return jax.make_array_from_callback((N,), block_sharding(mesh), cb)


def stage_file_block(path: str, mesh):
    """Stage a file block-sharded over the mesh; each process reads only
    its addressable shards' byte ranges (zero-padded past EOF).

    Returns (xb, n, N): the (N,) uint8 device array, the file size, and
    the padded global length.
    """
    n = os.path.getsize(path)
    p = num_shards(mesh)
    N = padded_size(max(n, 1), p, multiple=8)
    with open(path, "rb") as f:

        def read_range(lo, m):
            f.seek(lo)
            return np.frombuffer(f.read(m), np.uint8)

        return _staged_bytes(read_range, n, N, mesh), n, N


def stage_bytes_block(text, mesh):
    """Stage an in-memory byte string block-sharded over the mesh without
    materializing a padded host copy (per-shard zero-copy views)."""
    buf = np.frombuffer(bytes(text), np.uint8) \
        if isinstance(text, (bytes, bytearray)) else np.asarray(text)
    n = len(buf)
    p = num_shards(mesh)
    N = padded_size(max(n, 1), p, multiple=8)
    return _staged_bytes(lambda lo, m: buf[lo:lo + m], n, N, mesh), n, N


def staged_histogram(xb, mesh) -> np.ndarray:
    """(256,) int64 global byte histogram of a staged uint8 array, computed
    on device (per-shard bincount + cross-shard reduction; replicated
    result, so every process reads the same value)."""
    key = (mesh_key(mesh), xb.shape[0])
    if key not in _HIST_CACHE:

        def hist_local(x_l):
            # per-shard counts fit int32 (shard < 2^31); the cross-shard
            # psum runs on two 16-bit halves so >2^31-char single-byte
            # corpora cannot overflow int32 lanes (psum is the only
            # statically-replicated reduction under shard_map)
            h = jnp.zeros((256,), jnp.int32).at[x_l.astype(jnp.int32)].add(1)
            lo = lax.psum(h & 0xFFFF, AXIS)
            hi = lax.psum(h >> 16, AXIS)
            return jnp.stack([lo, hi])

        _HIST_CACHE[key] = jax.jit(jax.shard_map(
            hist_local, mesh=mesh, in_specs=(P(AXIS),), out_specs=P()))
    halves = np.asarray(jax.device_get(_HIST_CACHE[key](xb)), np.int64)
    return (halves[1] << 16) + halves[0]
