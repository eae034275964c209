"""Device mesh construction.

The reference is one Python thread (SURVEY.md section 2: no parallelism of any
kind); this framework scales on two orthogonal axes instead:

* ``data``  — independent work: sequences, GOPs (each GOP restarts from an
  I-frame with cleared references, so GOPs are embarrassingly parallel), or
  sweep configurations (QP / bitrate grids from the RD experiment drivers).
* ``space`` — bands of block rows within a frame.  Motion search needs a halo
  of ``search_range`` rows from neighbouring bands, exchanged with
  ``lax.ppermute`` (see spatial.py).

The mesh is plain device order: the GPUs of one host reach each other all to
all over NVLink, so no placement is better than another.
"""

import math

import jax
import numpy as np
from jax.sharding import Mesh


def default_mesh_shape(n_devices: int, n_sequences: int = 1) -> tuple[int, int]:
    """Pick (data, space) so space divides the device count and data covers
    available independent work."""
    data = math.gcd(n_sequences, n_devices)
    return data, n_devices // data


def make_mesh(n_devices: int | None = None, data: int | None = None,
              space: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if data is None or space is None:
        data, space = default_mesh_shape(n_devices)
    assert data * space == n_devices, (data, space, n_devices)
    grid = np.asarray(devices[:n_devices]).reshape(data, space)
    return Mesh(grid, axis_names=("data", "space"))
