"""The platform module: device naming, the GPU requirement, and the
compile-cache rule."""

import os
import subprocess
import sys

import jax
import pytest

from vhr_tpu import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_info_names_the_device():
    info = backend.device_info()
    assert info == {"platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


@pytest.mark.parametrize("platform,count,ok", [
    ("gpu", 1, True), ("gpu", 4, False), ("cpu", 1, False)])
def test_require_gpu(monkeypatch, platform, count, ok):
    """A measurement run needs the card; it never falls back to the CPU."""
    monkeypatch.setattr(backend, "device_info", lambda: {
        "platform": platform, "kind": "k", "count": 1})
    if ok:
        assert backend.require_gpu(count)["platform"] == "gpu"
    else:
        with pytest.raises(RuntimeError, match="no fallback"):
            backend.require_gpu(count)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it is used
    and nothing is set in code."""
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("env", [None, ""])
def test_compile_cache_defaults_to_checkout(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(backend.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(backend.CACHE_ENV, env)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = backend.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_importing_the_package_sets_no_cache():
    code = ("import jax, vhr_tpu, vhr_tpu.pipeline.offline, vhr_tpu.serving;"
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in os.environ.items() if k != backend.CACHE_ENV}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"


def test_main_path_imports_no_optional_package():
    """The chip path imports nothing beyond JAX (and what JAX itself
    loads), numpy, scipy, optax, chex, einops and the standard library."""
    code = ("import sys, jax, jax.numpy, numpy, scipy.signal;"
            "before = set(sys.modules);"
            "import vhr_tpu.pipeline.offline, vhr_tpu.pipeline.live,"
            " vhr_tpu.serving, vhr_tpu.pipeline.evm, vhr_tpu.parallel.long,"
            " vhr_tpu.parallel.streams, vhr_tpu.models.mediapipe_face,"
            " vhr_tpu.models.tflite, vhr_tpu.utils.realface,"
            " vhr_tpu.validation, vhr_tpu.backend;"
            "new = {m.split('.')[0] for m in set(sys.modules) - before};"
            "print(sorted(new & {'flatbuffers', 'cv2', 'matplotlib', 'flax',"
            " 'orbax', 'sklearn', 'tensorflow'}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_module_imports_flatbuffers():
    """JAX itself loads ``flatbuffers``, so the import check above cannot
    see it: read every module's imports instead."""
    import ast
    import glob

    for path in glob.glob(os.path.join(REPO, "vhr_tpu", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not any(n.split(".")[0] == "flatbuffers" for n in names), \
                path
