"""Non-power-of-two shard counts (the reference runs awkward MPI rank
counts, e.g. 13 — ``test/test_psac.cpp`` under ``mpiexec -np 13``).

The bitonic merge-split sort needs 2^k shards; other counts take the
odd-even block-transposition path (``parallel/sort.py``).  The conftest
pins this process to 8 virtual devices, so odd meshes run in a
subprocess with its own device count.
"""

import os
import subprocess
import sys

import numpy as np

_WORKER = r"""
import os, sys
p = int(sys.argv[1]); path = sys.argv[2]
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
import jax
jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == p

import functools
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from psac_tpu.parallel.mesh import AXIS, make_mesh, block_sharding
from psac_tpu.parallel.sort import dist_sort_local

mesh = make_mesh(p)

# raw distributed sort vs numpy on an odd mesh (ties broken by unique gidx)
rng = np.random.RandomState(7)
n = 13 * p * 16
keys = rng.randint(0, 50, n).astype(np.int32)
gidx = np.arange(n, dtype=np.int32)
f = jax.jit(jax.shard_map(
    functools.partial(dist_sort_local, num_keys=2, p=p),
    mesh=mesh, in_specs=((P(AXIS), P(AXIS)),), out_specs=(P(AXIS), P(AXIS))))
ks, gs = f((jax.device_put(keys, block_sharding(mesh)),
            jax.device_put(gidx, block_sharding(mesh))))
order = np.lexsort((gidx, keys))
assert np.array_equal(np.asarray(ks), keys[order]), "sorted keys mismatch"
assert np.array_equal(np.asarray(gs), gidx[order]), "sorted gidx mismatch"

# end to end: SA+LCP on the odd mesh vs the sequential oracle
import psac_tpu
from psac_tpu.ops.oracle import lcp_kasai, suffix_array_np
res = psac_tpu.build_suffix_array(b"mississippi", mesh=mesh)
assert list(res.sa) == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2], res.sa
assert list(res.lcp) == [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3], res.lcp
text = open(path, "rb").read()
res = psac_tpu.build_suffix_array(text, mesh=mesh)
want = suffix_array_np(text)
assert np.array_equal(res.sa, want), "SA != oracle"
assert np.array_equal(res.lcp, lcp_kasai(text, want)), "LCP != oracle"
print(f"odd mesh p={p}: sort + SA+LCP of {len(text)} bytes OK")
"""


def _run(p: int, tmp_path) -> None:
    rng = np.random.RandomState(100 + p)
    text = bytes(rng.randint(97, 103, 9000).astype(np.uint8))
    path = tmp_path / "corpus.bin"
    path.write_bytes(text)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, str(worker), str(p), str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, f"p={p} failed:\n{out.stdout}\n{out.stderr}"
    assert f"odd mesh p={p}" in out.stdout


def test_mesh_p13(tmp_path):
    _run(13, tmp_path)


def test_mesh_p6(tmp_path):
    _run(6, tmp_path)
