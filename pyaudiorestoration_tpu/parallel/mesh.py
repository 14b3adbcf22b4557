"""Device-mesh construction for the audio-restoration framework.

Mesh axes (SURVEY.md §2.4):
* ``files`` — data parallelism over a batch of recordings (the reference's
  sequential batch loops, resampling.py:168, dropouts_gui.py:121-135).
* ``time``  — context/sequence parallelism along the recording, the device-mesh
  version of the reference's blockwise-overlap streaming
  (experiments/pyrespeeder_cmd.py:16-49).  Halos move between devices via
  ``ppermute``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "P", "NamedSharding", "shard_time_batch"]


def make_mesh(n_files: int = 1, n_time: int | None = None, devices=None) -> Mesh:
    """Build a ('files', 'time') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_time is None:
        n_time = n // n_files
    assert n_files * n_time == n, f"{n_files}x{n_time} != {n} devices"
    dev_array = np.asarray(devices).reshape(n_files, n_time)
    return Mesh(dev_array, axis_names=("files", "time"))


def shard_time_batch(mesh: Mesh, batch):
    """Place a (files, time) array batch onto the mesh."""
    return jax.device_put(batch, NamedSharding(mesh, P("files", "time")))
