"""Device selection, the compile cache's location, the native codec's
per-host build, the seeded take generator, and the GPU entry scripts'
refusal to run without a GPU."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from pyaudiorestoration_tpu.utils import audio_io, device
from pyaudiorestoration_tpu.utils.synth import wow_take

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_best_device_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.best_device()


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert device.compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    assert path == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_cache_sets_dir_only_without_env(monkeypatch, tmp_path,
                                                env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the code
    sets no directory; without it, the fixed default is configured."""
    monkeypatch.delenv("PYTEST_CURRENT_TEST", raising=False)
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(device, "_DEFAULT_CACHE_DIR",
                            str(tmp_path / "default"))
    (tmp_path / ("env" if env_set else "default")).mkdir()
    stale = tmp_path / ("env" if env_set else "default") / "entry-tmp"
    stale.write_bytes(b"")
    device.enable_persistent_compile_cache()
    if env_set:
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == str(tmp_path / "default")
    assert not stale.exists()  # empty leftovers are swept


def test_native_lib_path_is_keyed_to_sources_and_host(monkeypatch):
    monkeypatch.delenv("AUDIOIO_LIB", raising=False)
    path = pathlib.Path(audio_io._lib_path())
    assert path.name == "libaudioio.so"
    assert path.parent.parent == pathlib.Path(audio_io._NATIVE_DIR) / "build"
    assert re.fullmatch(r"[0-9a-f]{16}", path.parent.name)
    assert path.parent.name == audio_io._host_build_key()
    monkeypatch.setenv("AUDIOIO_LIB", "/some/other/lib.so")
    assert audio_io._lib_path() == "/some/other/lib.so"


def test_native_build_key_follows_sources(monkeypatch, tmp_path):
    """A library built from another audioio.cpp (or on another host) lives
    under another key, so it is never loaded."""
    for name in ("audioio.cpp", "Makefile"):
        shutil.copy(os.path.join(audio_io._NATIVE_DIR, name), tmp_path)
    monkeypatch.setattr(audio_io, "_NATIVE_DIR", str(tmp_path))
    key = audio_io._host_build_key()
    with open(tmp_path / "audioio.cpp", "a") as f:
        f.write("// edited\n")
    assert audio_io._host_build_key() != key


@pytest.mark.parametrize("seed", [0, 5])
def test_wow_take_is_seeded(seed):
    a, sa = wow_take(0.5, 8000, 2, seed=seed)
    b, sb = wow_take(0.5, 8000, 2, seed=seed)
    c, _ = wow_take(0.5, 8000, 2, seed=seed + 1)
    assert a.shape == (4000, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    assert not np.array_equal(a, c)
    assert np.all(np.abs(sa - 1) <= 0.003 + 0.001 + 1e-12)
    # channel 1 is the same tone at 0.8 of the level, with its own hiss
    ratio = np.std(a[:, 1]) / np.std(a[:, 0])
    assert abs(ratio - 0.8) < 0.01


def test_wow_take_tone_follows_speed():
    """The pilot's instantaneous frequency is f0 times the speed curve."""
    sr, f0 = 192000, 3150.0
    x, speed = wow_take(1.0, sr, 1, f0=f0, noise=0.0, seed=3)
    x = x[:, 0].astype(np.float64)
    up = np.where((x[:-1] < 0) & (x[1:] >= 0))[0]
    t = up - x[up] / (x[up + 1] - x[up])  # sub-sample upward crossings
    inst = sr / np.diff(t)
    mid = ((t[:-1] + t[1:]) / 2).astype(int)
    np.testing.assert_allclose(inst, f0 * speed[mid], rtol=5e-5)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
