"""chip_smoke.py's harness on the CPU: the device check, and the card checks
run CPU against CPU at small widths (the card runs them at full width)."""
import types

import pytest

import chip_smoke as CS


@pytest.mark.parametrize("platform", ["cpu", "rocm", None])
def test_require_gpu_refuses_other_platforms(platform):
    devs = [] if platform is None else [types.SimpleNamespace(
        platform=platform, device_kind="x")]
    with pytest.raises(SystemExit):
        CS.require_gpu(devs)


def test_require_gpu_accepts_gpu():
    CS.require_gpu([types.SimpleNamespace(platform="gpu", device_kind="H100")])


@pytest.mark.parametrize("check,kw", [
    (CS.check_fast, dict(h=120, w=160)),
    (CS.check_search, dict(n=200)),
    (CS.check_lk, dict(n=64, h=240, w=320)),
])
def test_card_check_runs_on_host(host, check, kw):
    assert check(host, host, **kw)


@pytest.mark.parametrize("module", ["fast", "matching", "klt"])
def test_front_end_kernels_have_one_code_path(module):
    """FAST, the projection search and LK compile the same jitted code on
    every backend: no branch on the platform or the device."""
    import importlib
    import inspect
    src = inspect.getsource(importlib.import_module(f"geoflowslam.ops.{module}"))
    for needle in ("platform", "devices(", "default_backend", "pallas"):
        assert needle not in src, (module, needle)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from geoflowslam.utils import compile_log as CL
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert CL.cache_dir() == str(tmp_path)


def test_compile_cache_default_inside_checkout(monkeypatch):
    import os
    from geoflowslam.utils import compile_log as CL
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = CL.cache_dir()
    assert os.path.commonpath([d, root]) == root and d != root
    with open(os.path.join(root, ".gitignore")) as f:
        assert os.path.relpath(d, root) + "/" in f.read().split()
