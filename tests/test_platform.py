"""Platform helpers and the card-only entry points: the compile-cache
directory, the GPU selector, and chip_smoke.py / bench.py refusing to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from coulomb_gmg.utils import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_dir_from_env_sets_no_path(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert platform.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = platform.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_gpu_selector_on_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    assert platform.select_device() is None
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_entry_points_refuse_cpu(script):
    p = _run([os.path.join(ROOT, script)], cwd=ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "no GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert p.returncode != 0 and '"ok"' not in p.stdout


def test_cli_gpu_mode_refuses_cpu(tmp_path):
    from coulomb_gmg.cli import main
    prm = tmp_path / "p.prm"
    prm.write_text("subsection Misc\n  set Number of Adaptive Refinement"
                   " = 1\nend\n")
    with pytest.raises(RuntimeError, match="no GPU"):
        main([str(prm)])
