"""chip_smoke.py: its phases at tiny sizes on the CPU mesh, its oracles,
its refusal to run without a GPU, and the compile-cache placement."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("kind,force_int64", [("random", False),
                                              ("repetitive", True)])
def test_phase_sa(mesh1, kind, force_int64):
    out = chip_smoke.phase_sa(mesh1, 4096, kind=kind, seed=3,
                              force_int64=force_int64, show_program=True)
    assert out["fused"] and out["host_iters"] == 0


def test_phase_sa_four_shards():
    """The four-card SA path on four virtual devices: shards land on four
    distinct devices and the result equals the oracle."""
    from psac_tpu.parallel.mesh import make_mesh

    chip_smoke.phase_sa(make_mesh(4), 4096)


def test_phase_st(mesh1):
    out = chip_smoke.phase_st(mesh1, 2048, 4096)
    assert out["st_best"] > 0


def test_phase_gsa(mesh1):
    out = chip_smoke.phase_gsa(mesh1, 12, 64, 4, 128)
    assert out["gst_best"] > 0


def test_phase_desa(mesh1):
    out = chip_smoke.phase_desa(mesh1, 4096, count=16)
    assert set(out) == {(t, m) for t in ("tllt", "tldt") for m in (8, 20, 64)}


def test_occurrences_equal_find_scan():
    """The vectorized window scan equals a plain ``bytes.find`` scan,
    including patterns longer than one 32-char window key, duplicates,
    out-of-alphabet and over-long patterns."""
    from psac_tpu.ops.alphabet import rand_dna, rep_dna

    text = rand_dna(3000, seed=5) + rep_dna(3000, unit_len=100, seed=6)
    pats = chip_smoke.dna_patterns(text, (1, 8, 20, 40, 64), 10, seed=2)
    pats += [pats[3], b"", b"ACGN", text[:50], text * 2]

    def find_all(pt):
        out, st = [], 0
        while pt:
            i = text.find(pt, st)
            if i < 0:
                break
            out.append(i)
            st = i + 1
        return np.array(out, np.int64)

    for pt, got in zip(pats, chip_smoke.occurrences(text, pats)):
        np.testing.assert_array_equal(np.sort(got), find_all(pt),
                                      err_msg=repr(pt))


def test_dna_patterns_half_absent():
    from psac_tpu.ops.alphabet import rand_dna

    text = rand_dna(1 << 12, seed=1)
    pats = chip_smoke.dna_patterns(text, (8, 20), 8)
    assert [len(p) for p in pats] == [8] * 8 + [20] * 8
    occ = chip_smoke.occurrences(text, pats)
    for k in (0, 8):
        assert all(len(o) > 0 for o in occ[k:k + 4])
        assert all(len(o) == 0 for o in occ[k + 4:k + 8])


def test_sort_lowering_counts():
    hlo = '''
  %sort.1 = (s32[8]{0}, s32[8]{0}) sort(s32[8]{0} %a, s32[8]{0} %b), dimensions={0}
  %cc = (s32[8]{0}, u8[64]{0}) custom-call(s32[8]{0} %k), custom_call_target="__cub$DeviceRadixSort"
  %sort_like_name = s32[8]{0} add(s32[8]{0} %a, s32[8]{0} %b)
'''
    assert chip_smoke.sort_lowering(hlo) == {
        "comparator_sort": 1, "__cub$DeviceRadixSort": 1}


def _run_smoke(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_main_refuses_cpu():
    """Without a GPU the script exits non-zero and prints no result line."""
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_main_refuses_cpu_in_process(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the package, the script fails."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """Every smoke phase, at small sizes, compiled for the card."""
    import psac_tpu
    from psac_tpu.parallel.mesh import make_mesh

    psac_tpu.enable_compile_cache()
    mesh = make_mesh(1)
    chip_smoke.phase_sa(mesh, 1 << 16, show_program=True)
    chip_smoke.phase_sa(mesh, 1 << 16, kind="repetitive", seed=0,
                        force_int64=True)
    chip_smoke.phase_st(mesh, 1 << 14, 1 << 16)
    chip_smoke.phase_gsa(mesh, 32, 256, 64, 512)
    chip_smoke.phase_desa(mesh, 1 << 16, count=64)


# ---- compile-cache placement (psac_tpu.enable_compile_cache) -------------

def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    import psac_tpu

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert psac_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default(monkeypatch):
    import psac_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert psac_tpu.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_not_enabled_on_cpu(monkeypatch):
    """XLA:CPU executables are never persisted (unsafe in this jaxlib)."""
    import jax

    import psac_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    psac_tpu.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_on_accelerator(monkeypatch, tmp_path, env_dir):
    """On an accelerator backend the cache goes to the fixed in-checkout
    directory, unless JAX_COMPILATION_CACHE_DIR names one — then no
    directory is set in code."""
    import jax

    import psac_tpu

    calls = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("PSAC_NO_COMPILE_CACHE", raising=False)
    psac_tpu.enable_compile_cache()
    if env_dir:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == os.path.join(
            ROOT, ".jax_cache")
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0
