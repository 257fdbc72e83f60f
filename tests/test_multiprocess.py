"""A real multi-process construction: 2 ``jax.distributed`` CPU processes
x 4 virtual devices each = one global 8-shard mesh.

The reference tests multi-node the same way — oversubscribed ``mpiexec``
processes on one machine (SURVEY.md §4, ``.travis.yml:72-90``).  The
worker stages the input from a FILE with per-process shard reads
(``construct_from_file`` -> ``parallel/staging.py``; reference
``src/psac.cpp:85`` ``file_block_decompose``), builds SA+LCP on the global
mesh, runs the fully distributed checker (``d_check_sa``, reference
``check_suffix_array.hpp:206-267``), and cross-checks the gathered result
against the sequential oracle.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; path = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

import numpy as np
from psac_tpu.parallel.mesh import make_mesh
from psac_tpu.models.suffix_array import construct_from_file
from psac_tpu.verify.check_sa import d_check_sa

mesh = make_mesh(8)
dsa, xs = construct_from_file(path, mesh=mesh)
assert d_check_sa(dsa, xs), "distributed SA check failed"

# gather to every process and cross-check vs the sequential oracle
from jax.experimental import multihost_utils
sa = np.asarray(multihost_utils.process_allgather(dsa.sa, tiled=True))
lcp = np.asarray(multihost_utils.process_allgather(dsa.lcp, tiled=True))
off = dsa.N - dsa.n
from psac_tpu.ops.oracle import lcp_kasai, suffix_array_np
text = open(path, "rb").read()
want = suffix_array_np(text)
assert np.array_equal(sa[off:], want), "SA != oracle"
assert np.array_equal(lcp[off:], lcp_kasai(text, want)), "LCP != oracle"
print(f"proc {pid}: multiprocess SA+LCP of {dsa.n} bytes OK")
"""


def test_two_process_distributed_build(tmp_path):
    rng = np.random.RandomState(42)
    text = bytes(rng.randint(97, 101, 20000).astype(np.uint8))
    path = tmp_path / "corpus.bin"
    path.write_bytes(text)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env.pop("XLA_FLAGS", None)
    port = "39247"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, str(path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = [p.communicate(timeout=850)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{outs[i][-4000:]}"
        assert f"proc {i}: multiprocess SA+LCP" in outs[i]


_WORKER_WIDE = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; sdir = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

import numpy as np
from jax.experimental import multihost_utils
from psac_tpu.parallel.mesh import make_mesh

mesh = make_mesh(8)
gather = lambda a: np.asarray(multihost_utils.process_allgather(a, tiled=True))

# ---- SA+LCP: distributed per-process write -> distributed reload --------
from psac_tpu import io as io_mod
from psac_tpu.models.suffix_array import construct_from_file

corpus = os.path.join(sdir, "corpus.bin")
dsa, xs = construct_from_file(corpus, mesh=mesh)
pre = os.path.join(sdir, "art")
io_mod.write_suffix_array_distributed(pre, dsa)
multihost_utils.sync_global_devices("after-write")
back = io_mod.read_suffix_array_distributed(pre, mesh)
assert back.n == dsa.n and back.N == dsa.N
off = dsa.N - dsa.n  # compare real rows (reload zero-fills the padding)
sa0, sa1 = gather(dsa.sa)[off:], gather(back.sa)[off:]
assert np.array_equal(sa0, sa1), "write->reload SA mismatch"
lcp0 = gather(dsa.lcp)[off:].copy()
lcp1 = gather(back.lcp)[off:]
lcp0[0] = 0  # the write applies materialize()'s first-row fixup
assert np.array_equal(lcp0, lcp1), "write->reload LCP mismatch"
print(f"proc {pid}: distributed write->reload OK")

# ---- GSA + GST across both processes (staged stringset file) ------------
from psac_tpu.models.gsa import build_gsa_from_file
from psac_tpu.models.suffix_tree import construct_gst_device

sfile = os.path.join(sdir, "strings.txt")
dgsa = build_gsa_from_file(sfile, mesh=mesh)
goff = dgsa.N - dgsa.n
gsa = gather(dgsa.sa)[goff:]
glcp = gather(dgsa.lcp)[goff:].copy()
glcp[0] = 0
parts = [x for x in open(sfile, "rb").read().split(b"\n") if x]
flat = b"".join(parts)
lens = np.array([len(x) for x in parts], np.int64)
eos_h = np.repeat(np.cumsum(lens), lens)
order = sorted(range(len(flat)), key=lambda i: (flat[i:eos_h[i]], i))
assert np.array_equal(gsa, np.array(order)), "GSA != oracle"
want_lcp = np.zeros(len(flat), np.int64)
for j in range(1, len(flat)):
    a = flat[order[j - 1]:eos_h[order[j - 1]]]
    b = flat[order[j]:eos_h[order[j]]]
    k = 0
    while k < len(a) and k < len(b) and a[k] == b[k]:
        k += 1
    want_lcp[j] = k
assert np.array_equal(glcp, want_lcp), "GLCP != oracle"
dgst = construct_gst_device(dgsa)
nodes = gather(dgst.nodes).reshape(dgst.N, dgst.sigma + 1)[goff:]
from psac_tpu.ops.alphabet import Alphabet
from psac_tpu.verify.suffix_tree_oracle import gst_oracle
alpha = Alphabet.from_bytes(flat)
want_nodes = gst_oracle(alpha.encode(flat), np.array(order), want_lcp,
                        eos_h, alpha.sigma)
assert np.array_equal(nodes, want_nodes), "GST != oracle"
print(f"proc {pid}: multiprocess GSA+GST OK")

# ---- DESA bulk_locate across both processes ------------------------------
from psac_tpu.models.desa import build_desa

text = open(corpus, "rb").read()
idx = build_desa(text, mesh=mesh)
pats = [text[0:8], text[100:110], text[777:781], b"zzzz", text[5000:5032]]
ranges = idx.bulk_locate(pats)
for pat, (l, r) in zip(pats, ranges):
    occ = sum(1 for i in range(len(text) - len(pat) + 1)
              if text[i:i + len(pat)] == pat)
    assert r - l == occ, (pat, l, r, occ)
print(f"proc {pid}: multiprocess DESA bulk_locate OK")

# ---- staged DESA build from file (O(n/p) host bytes per process) ---------
# + distributed per-process artifact write -> staged reload
from psac_tpu.models.desa import (build_desa_from_file, read_desa_from_file,
                                  write_desa_distributed)

idx2 = build_desa_from_file(corpus, mesh=mesh)
got2 = idx2.bulk_locate(pats)
assert [tuple(x) for x in got2] == [tuple(x) for x in ranges], "staged DESA"
dpre = os.path.join(sdir, "desa_art")
write_desa_distributed(idx2, dpre)
multihost_utils.sync_global_devices("after-desa-write")
idx3 = read_desa_from_file(corpus, dpre, mesh=mesh)
got3 = idx3.bulk_locate(pats)
assert [tuple(x) for x in got3] == [tuple(x) for x in ranges], "DESA reload"
print(f"proc {pid}: staged DESA build+IO OK")
"""


def test_two_process_gsa_st_desa_io(tmp_path):
    """Multi-process coverage beyond SA: per-process shard writes + reload,
    GSA+GST from a staged stringset file, and DESA bulk_locate — across 2
    real jax.distributed processes."""
    rng = np.random.RandomState(7)
    text = bytes(rng.randint(97, 101, 8000).astype(np.uint8))
    (tmp_path / "corpus.bin").write_bytes(text)
    parts = [bytes(rng.randint(97, 103, rng.randint(1, 80)).astype(np.uint8))
             for _ in range(40)]
    (tmp_path / "strings.txt").write_bytes(b"\n".join(parts) + b"\n")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER_WIDE)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env.pop("XLA_FLAGS", None)
    port = "39251"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = [p.communicate(timeout=850)[0].decode() for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"proc {i} failed:\n{outs[i][-4000:]}"
        assert f"proc {i}: distributed write->reload OK" in outs[i]
        assert f"proc {i}: multiprocess GSA+GST OK" in outs[i]
        assert f"proc {i}: multiprocess DESA bulk_locate OK" in outs[i]
        assert f"proc {i}: staged DESA build+IO OK" in outs[i]
