"""Device mesh helpers for data-parallel alignment.

The scale-out plan (SURVEY §2.3 / §5): replicate the LSH index + traversal
matrices per device (small — hundreds of graphs of 1-2 kb genes), shard FASTQ
read batches over a 1-D "data" mesh axis, and allreduce (psum) the per-graph
k-mer tallies and mapped-read counters before prune/EM. The mesh is one flat
axis, which suits cards joined all to all (NVLink); nothing here assumes a
fixed device count.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} present"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def pad_batch_for_mesh(codes: np.ndarray, lengths: np.ndarray, n_shards: int):
    """Pad the batch dim to a multiple of the mesh size (padding reads have
    length 0 and map nowhere)."""
    B = codes.shape[0]
    Bp = -(-B // n_shards) * n_shards
    if Bp != B:
        codes = np.concatenate(
            [codes, np.full((Bp - B, codes.shape[1]), 4, dtype=codes.dtype)]
        )
        lengths = np.concatenate(
            [lengths, np.zeros(Bp - B, dtype=lengths.dtype)]
        )
    return codes, lengths, B
