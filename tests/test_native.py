"""Native SA-IS + Kasai oracle vs the independent NumPy oracles."""

import numpy as np
import pytest

from psac_tpu import native
from psac_tpu.ops.alphabet import rand_dna
from psac_tpu.ops.oracle import lcp_kasai, suffix_array_naive, suffix_array_np


@pytest.mark.parametrize("text", [
    b"mississippi", b"banana", b"a", b"ab", b"ba", b"aaaaaaa", b"abab",
    b"abracadabra" * 3, bytes(range(1, 256)),
])
def test_sais_small(text):
    np.testing.assert_array_equal(native.suffix_array(text), suffix_array_naive(text))


@pytest.mark.parametrize("n", [100, 1000, 130370])
def test_sais_random(n):
    text = rand_dna(n, seed=n)
    np.testing.assert_array_equal(native.suffix_array(text), suffix_array_np(text))


def test_sais_random_bytes():
    rng = np.random.RandomState(0)
    text = rng.randint(1, 256, size=50000, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(native.suffix_array(text), suffix_array_np(text))


def test_kasai_native():
    text = rand_dna(5000, seed=1)
    sa = native.suffix_array(text)
    np.testing.assert_array_equal(native.lcp_array(text, sa), lcp_kasai(text, sa))


def test_native_builds_from_source(tmp_path, monkeypatch):
    """The oracle library is never committed: ``_build`` compiles
    ``sais.cpp`` and publishes it by an atomic rename, leaving no temporary
    file behind; the fresh library answers like the NumPy oracle."""
    so = tmp_path / "libpsac_native.so"
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_lib", None)
    native._build()
    assert so.exists()
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    text = rand_dna(3000, seed=4)
    sa = native.suffix_array(text)
    np.testing.assert_array_equal(sa, suffix_array_np(text))
    np.testing.assert_array_equal(native.lcp_array(text, sa),
                                  lcp_kasai(text, sa))
