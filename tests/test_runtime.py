"""Runtime plumbing: the peak-bandwidth table, the compile-cache
placement, the native parser build, and chip_smoke.py's refusal to run
anywhere but on a GPU with this checkout's package."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from krylov_crn_tpu import config
from krylov_crn_tpu.utils import profiling

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12),
    ("NVIDIA H200", 4.8e12),
])
def test_peak_table(kind, peak):
    assert profiling.peak_bytes_per_s(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "unknown"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak bandwidth"):
        profiling.peak_bytes_per_s(kind)


def test_peak_of_cpu_device_raises():
    """No peak is assumed for the device JAX found (the CPU here)."""
    with pytest.raises(KeyError):
        profiling.peak_bytes_per_s()


def test_kernel_time_needs_device_kernels():
    """A profile without device kernels (the CPU here) raises instead of
    reporting a zero time."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: a @ a)
    with pytest.raises(RuntimeError, match="no device kernels"):
        profiling.kernel_time_per_call(f, (jnp.ones((64, 64)),), calls=2,
                                       windows=1)


@pytest.mark.parametrize("secs,raises", [
    ([1e-8, 2e-8, 3e-8], True),  # 1e14 B/s: above any card's peak
    ([1.0, 1.0, 2.0], False),
])
def test_kmatvec_times_rejects_rates_above_peak(monkeypatch, secs, raises):
    import bench

    monkeypatch.setattr(profiling, "kernel_time_per_call",
                        lambda fn, args: list(secs))
    monkeypatch.setattr(profiling, "peak_bytes_per_s", lambda: 3.35e12)
    K = np.eye(512, dtype=np.float32)
    if raises:
        with pytest.raises(RuntimeError, match="above the card's"):
            bench.kmatvec_times(K)
    else:
        out = bench.kmatvec_times(K)
        assert out["xla_ms"] == 1e3 and out["xla_ms_range"] == [1e3, 2e3]
        assert 0 < out["symv_peak_frac"] < out["xla_peak_frac"] < 1


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(config.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_compilation_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    config.enable_compilation_cache()
    assert calls == []  # JAX reads the variable itself; nothing is set
    assert config.compilation_cache_dir() == str(tmp_path)


def test_compilation_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    config.enable_compilation_cache()
    assert ("jax_compilation_cache_dir",
            str(config.DEFAULT_CACHE_DIR)) in calls
    assert config.compilation_cache_dir() == str(config.DEFAULT_CACHE_DIR)
    assert config.DEFAULT_CACHE_DIR.parent == REPO
    ignored = (REPO / ".gitignore").read_text().split()
    assert config.DEFAULT_CACHE_DIR.name + "/" in ignored


def test_native_parser_builds_from_source(monkeypatch, tmp_path):
    """A checkout carries only libsvm_parser.c: the library is compiled
    on first use (to a temporary name, renamed into place)."""
    if shutil.which(os.environ.get("CC", "cc")) is None:
        pytest.skip("no C compiler")
    from krylov_crn_tpu.native import libsvm_native as ln

    so = tmp_path / "_libsvm_parser.so"
    monkeypatch.setattr(ln, "_HERE", tmp_path)
    monkeypatch.setattr(ln, "_SO", so)
    monkeypatch.setattr(ln, "_lib", None)
    labels, rows, cols, vals = ln.parse(b"1 1:0.5 3:2\n-1 2:1.5\n")
    assert so.exists() and sorted(p.name for p in tmp_path.iterdir()) == \
        [so.name]
    np.testing.assert_array_equal(labels, [1.0, -1.0])
    np.testing.assert_array_equal(rows, [0, 0, 1])
    np.testing.assert_array_equal(cols, [1, 3, 2])
    np.testing.assert_array_equal(vals, [0.5, 2.0, 1.5])


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr + r.stdout


def test_chip_smoke_needs_the_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
