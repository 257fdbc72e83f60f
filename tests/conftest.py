"""Test harness: 8 virtual CPU devices (the reference tests the same way —
oversubscribed mpiexec on one machine, SURVEY.md §4).

``PSAC_TEST_ON_GPU=1`` leaves JAX on its default backend instead, for the
``gpu``-marked tests: ``PSAC_TEST_ON_GPU=1 python -m pytest -m gpu -n 0
tests/`` on a GPU host (one process: a second one could not reserve the
card's memory)."""

import os

if os.environ.get("PSAC_TEST_ON_GPU") != "1":
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

if os.environ.get("PSAC_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Quick-signal tier (`pytest -m smoke`, target < 3 min on the single-core
# build host): mississippi goldens + one small input per pipeline + one
# routing test, per the reference's smallest-tier coverage (SURVEY.md §4).
_SMOKE = {
    "test_bitops.py": None,  # whole file
    "test_native.py::test_sais_small": None,
    "test_rmq.py::test_local_rmq_exhaustive": None,
    "test_parallel.py::test_route_apply_echo": None,
    "test_parallel.py::test_global_shift": None,
    "test_ansv.py::test_oracle_vs_brute": None,
    "test_ansv.py::test_dist_vs_oracle_sizes[137]": None,
    "test_suffix_array.py::test_oracles_agree": None,
    "test_suffix_array.py::test_mississippi": None,
    "test_suffix_array.py::test_random_dna[1000]": None,
    "test_suffix_tree.py::test_st_golden": None,
    "test_gsa.py::test_gsa_repeat_family": None,
    "test_desa.py::test_desa_mississippi": None,
    "test_seq_query.py::test_seq_index_locate": None,
    "test_samplelcp.py::test_sample_lcp_equivalence": None,
    "test_ansv.py::test_st_pass_tile_edges[straddle-mesh1]": None,
    "test_ansv.py::test_st_pass_tile_edges[all_equal-mesh8]": None,
    "test_desa.py::test_construct_lc_config_wired": None,
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = item.nodeid.split("/")[-1]
        fname = name.split("::")[0]
        base = name.split("[")[0]
        if fname in _SMOKE or name in _SMOKE or base in _SMOKE:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def mesh8():
    from psac_tpu.parallel.mesh import make_mesh
    return make_mesh(8)


@pytest.fixture(scope="session")
def mesh1():
    from psac_tpu.parallel.mesh import make_mesh
    return make_mesh(1)


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX's default device is not one
    (decided here, at run time, so every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: PSAC_TEST_ON_GPU=1 python -m pytest "
                    "-m gpu -n 0 tests/ on a GPU host")
    return dev
