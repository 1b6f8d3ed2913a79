"""Read-batch sketching (hot loop #2): codes u8 [B, L] -> KHF MinHash [B, s].

The default is the native host sketcher (one C pass per batch, with the
slot-0 prescreen); without the native library the numpy golden batch path
runs. ``GROOT_DEVICE_SKETCH=1`` sketches on the device instead, through the
jnp ntHash of ``ops.nthash.khf_sketch`` (prefix-XOR scans, rotates and
min-reductions that XLA fuses)."""

from __future__ import annotations

import os

import numpy as np

from . import nthash


def _device_sketch() -> bool:
    return bool(os.environ.get("GROOT_DEVICE_SKETCH"))


def sketch_reads(codes, valid_len, k: int, s: int, prescreen=None):
    """Batch sketch as (hi, lo) uint32 [B, s] halves of the u64 sketches.
    The prescreen applies to the host sketcher only."""
    if _device_sketch():
        import jax.numpy as jnp

        hi, lo = nthash.khf_sketch(
            jnp.asarray(codes), k, s, valid_len=jnp.asarray(valid_len)
        )
        return np.asarray(hi), np.asarray(lo)
    u = sketch_reads_u64(codes, valid_len, k, s, prescreen)
    if u is None:
        u = nthash.khf_sketch_np_batch(
            np.asarray(codes), np.asarray(valid_len), k, s
        )
    return (
        (u >> np.uint64(32)).astype(np.uint32),
        (u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def sketch_reads_u64(codes, valid_len, k: int, s: int, prescreen=None):
    """The native sketcher's u64 [B, s] output, or None when the native
    library is unavailable or device sketching is selected (callers then
    use sketch_reads). Pair with query_batch_np(q64=...) to skip the hi/lo
    split and recombination."""
    if _device_sketch():
        return None
    from ..io import native

    return native.sketch(
        np.asarray(codes), np.asarray(valid_len), k, s, prescreen=prescreen
    )
