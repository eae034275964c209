"""Where the program runs and what it keeps: the compile cache's placement,
and the GPU-only entry points refusing to run on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the cache is there and nowhere
    else; without it, one fixed directory inside the checkout."""
    from basic_video_codec_tpu.utils import compcache

    probe = ("import jax; from basic_video_codec_tpu.utils import compcache;"
             "compcache.enable();"
             "print(jax.config.jax_compilation_cache_dir)")
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    out = _run(["-c", probe], env, drop=("JAX_COMPILATION_CACHE_DIR",
                                         "BVC_COMPCACHE"))
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if env_set else compcache.DEFAULT_DIR
    assert out.stdout.strip() == want
    assert os.path.dirname(compcache.DEFAULT_DIR) == ROOT


@pytest.mark.parametrize("backend", ["cuda", "cpu", ""])
def test_unknown_backend_rejected(backend):
    """Only "auto", "device" and "golden" name a pipeline; any other value
    is an error instead of silently running the device pipeline."""
    from basic_video_codec_tpu import EncoderConfig

    with pytest.raises(ValueError, match="backend"):
        EncoderConfig(8, 2, 4, 3, backend=backend)


def test_chip_smoke_refuses_cpu():
    """The device phase exits non-zero on the CPU instead of falling back."""
    out = _run(["chip_smoke.py", "--child", "device"], {})
    assert out.returncode != 0
    assert "no GPU" in out.stdout + out.stderr


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], {}, cwd=tmp_path)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_bench_refuses_cpu():
    out = _run(["bench.py"], {})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
