"""Mesh construction helpers.

The framework shards every length-N array block-wise over a single mesh axis
``AXIS`` — the mesh equivalent of the reference's ``mxx::blk_dist``
block distribution (reference ``include/dvector.hpp:50-150``). Multi-host
device sets are flattened onto this one logical axis; XLA routes the
collectives over whatever links join the devices, from the device order of
the mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "x"


def make_mesh(num_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (default: all).

    Power-of-two shard counts run the merge-split bitonic sort network
    (parallel/sort.py); other counts — the reference tests awkward MPI rank
    counts like 13 — fall back to odd-even block transposition (p stages),
    so any device count works.
    """
    devs = jax.devices()
    p = num_devices or len(devs)
    return jax.make_mesh((p,), (AXIS,), devices=np.asarray(devs[:p]))


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[AXIS]


def mesh_key(mesh: Mesh) -> tuple:
    """Stable cache key for a mesh: geometry + device identity.

    ``id(mesh)`` is unsafe as a jit-cache key — a garbage-collected mesh's id
    can be reused by a new mesh with different geometry, silently serving
    stale compiled programs.  Keying on the axis shape and the device ids is
    cheap and collision-free.
    """
    return (tuple(mesh.shape.items()),
            tuple(d.id for d in mesh.devices.flat))


def padded_size(n: int, p: int, multiple: int = 8) -> int:
    """Global padded size: divisible by p, lane-friendly, and quantized.

    Sizes are rounded up to quarter-power-of-two buckets (<= 25% padding) so
    different input lengths share compiled steps — jit programs are keyed on
    the padded shape.
    """
    chunk = p * multiple
    n = max(n, chunk)
    # next bucket of the form m * 2^e with m in {4, 5, 6, 7}
    e = max(0, n.bit_length() - 3)
    bucket = -(-n >> e) << e  # ceil to multiple of 2^e
    return ((bucket + chunk - 1) // chunk) * chunk
