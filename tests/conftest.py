"""Test harness config.

Tests run on the CPU with 8 virtual XLA devices, so multi-device sharding
(jax.sharding.Mesh) is exercised without a GPU.  Must be set before the
first ``import jax`` anywhere in the test process.  The program itself runs
on the GPU; ``python chip_smoke.py`` drives it there, and tests marked
``gpu`` skip here.
"""

import os
import sys

# Force CPU with 8 virtual devices.  The live config is updated as well, in
# case jax was already imported before this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compile cache: the per-module clear_caches below (segfault
# workaround) recompiles hundreds of program variants per full run; with
# the on-disk cache those reloads deserialize in ~1 s instead of
# recompiling in 5-40 s (measured 6.1 -> 0.98 s on the biggest intra
# chunk).  Same-host AOT reload; BVC_COMPCACHE=0 disables.  The noisy
# XLA "machine feature" E-lines on load are pseudo-feature tuning flags
# (prefer-no-scatter/gather), benign and captured by pytest.
from basic_video_codec_tpu.utils import compcache  # noqa: E402

compcache.enable()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from basic_video_codec_tpu.tools import ygen


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """The full suite compiles hundreds of program variants in one process;
    with a large in-process LLVM JIT history the CPU backend occasionally
    SEGFAULTS compiling the biggest programs (reproduced twice ~30 min in,
    on the cond-heavy mixed chunk; never in isolation).  Clearing the
    compile caches between modules keeps the JIT footprint bounded — worth
    the recompiles."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The GPU, for tests marked ``gpu``.  Skips where JAX runs on the CPU,
    as this suite does; chip_smoke.py runs the same paths on the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this path on the card")
    return dev


@pytest.fixture(scope="session")
def small_moving_y(tmp_path_factory):
    """A 64x48, 6-frame synthetic sequence with known motion, as a .y file."""
    path = tmp_path_factory.mktemp("data") / "moving64.y"
    frames = ygen.moving_sequence(64, 48, 6, seed=3)
    ygen.write_y_file(str(path), frames)
    return str(path), 64, 48, 6


@pytest.fixture(scope="session")
def tiny_textured_frames():
    return np.stack([ygen.textured_frame(32, 32, seed=s) for s in range(3)])
