"""Backend choice, compile cache and GPU-entry-point contracts, on CPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from pysurfinv_tpu.ops.dispersion import SurfConfig, _lane_backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "cpu", None),                  # CPU: the vmapped oracle
    ("auto", "gpu", False),                 # GPU: compiled kernels
    ("xla", "gpu", None),
    ("xla_assoc", "cpu", None),
    ("pallas_interpret", "cpu", True),
    ("pallas", "gpu", False),
])
def test_lane_backend_resolution(backend, platform, want, monkeypatch):
    """"auto" never interprets: compiled kernels on a GPU, the XLA
    oracle elsewhere; the interpreter only when asked for by name."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert _lane_backend(SurfConfig(backend=backend)) is want


@pytest.mark.parametrize("backend", ["pallas", "mosaic"])
def test_lane_backend_refuses(backend):
    """A GPU kernel named off a GPU, or an unknown name, raises — no
    silent fallback to another path."""
    assert jax.default_backend() == "cpu"
    with pytest.raises(ValueError):
        _lane_backend(SurfConfig(backend=backend))


def _cache_calls(monkeypatch, env):
    from pysurfinv_tpu import utils

    for k in ("PYSURFINV_JIT_CACHE", "JAX_COMPILATION_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    # record instead of applying: the suite runs with the cache off
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    return utils.configure_jit_cache(), calls


def test_jit_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins, and nothing else is set."""
    got, calls = _cache_calls(monkeypatch, {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert got == str(tmp_path)
    assert calls == []


def test_jit_cache_fixed_default(monkeypatch):
    """Without the env var: a fixed in-checkout dir that git ignores."""
    assert jax.config.jax_compilation_cache_dir is None
    got, calls = _cache_calls(monkeypatch, {})
    assert got == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", got) in calls
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_jit_cache_opt_out(monkeypatch):
    got, calls = _cache_calls(monkeypatch, {"PYSURFINV_JIT_CACHE": "0"})
    assert got is None and calls == []


def test_chip_smoke_refuses_cpu(capsys):
    """chip_smoke's device check refuses the CPU: exit 2, no result."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    with pytest.raises(RuntimeError):
        chip_smoke.gpu_devices(1)
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (chip_smoke.py and nothing else) it fails
    without printing a result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_parent_stays_off_jax():
    """bench.py's parent process never imports JAX: its phases run as
    sequential children, one JAX process holding the device at a
    time."""
    code = ("import sys; sys.path.insert(0, %r); import bench; "
            "print(json.dumps('jax' in sys.modules))" % ROOT)
    proc = subprocess.run([sys.executable, "-c", "import json; " + code],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) is False
