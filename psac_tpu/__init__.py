"""psac_tpu — suffix array / LCP / suffix tree / DESA framework in JAX.

A brand-new JAX/XLA re-design of the capabilities of patflick/psac
(distributed suffix-array + LCP construction via k-mer initial ranking and
prefix doubling, ANSV + suffix trees, generalized suffix arrays over string
sets, and the DESA distributed pattern-matching index), written for
accelerators behind a device mesh:

- the text is block-sharded over a 1-D ``jax.sharding.Mesh`` axis
  (the mesh equivalent of the reference's ``mxx::blk_dist``,
  cf. reference ``include/dvector.hpp``),
- the shift / sort / rebucket / permute phases of the doubling loop are
  ``jax.lax`` collectives (``ppermute``, all-to-all, distributed bitonic
  sort, segmented scans) under ``jax.shard_map``,
- per-shard hot loops are XLA-fused vector ops,
- everything under jit uses static shapes; dynamic early-exit decisions are
  staged from the host on O(1) scalars.

See SURVEY.md for the structural map of the reference this re-implements.
"""

import os as _os

#: default persistent compile-cache directory: fixed inside the checkout
#: (the path is part of the cache key, so a moving directory never hits)
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compile-cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``<repo root>/.jax_cache``."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_COMPILE_CACHE


def enable_compile_cache() -> None:
    """Persist compiled programs across processes (first compiles of the
    fused construction programs take tens of seconds).

    Deliberately NOT enabled at import: with XLA:CPU the persistent cache is
    unsafe in this jaxlib (executable serialization can segfault, and AOT
    results loaded on a host with different CPU features SIGILL).  The
    entry points (bench.py, chip_smoke.py, the CLI) call this; it no-ops
    on the CPU backend or with ``PSAC_NO_COMPILE_CACHE=1``.
    """
    if _os.environ.get("PSAC_NO_COMPILE_CACHE", "0") not in ("", "0"):
        return
    import jax

    if jax.default_backend() == "cpu":
        return
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from psac_tpu.models.suffix_array import SuffixArray, build_suffix_array  # noqa: F401
from psac_tpu.models.suffix_tree import build_suffix_tree  # noqa: F401
from psac_tpu.models.desa import DESA, build_desa  # noqa: F401
