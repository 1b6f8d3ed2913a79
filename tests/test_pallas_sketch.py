"""The device read-sketch path (GROOT_DEVICE_SKETCH=1: the jnp ntHash of
ops.nthash behind ops.sketch.sketch_reads) must equal the numpy goldens
bit for bit, and the host path must return the same sketches."""

import numpy as np

from groot_tpu.ops import nthash
from groot_tpu.ops.sketch import sketch_reads, sketch_reads_u64


def _join(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)


def test_pallas_sketch_matches_xla(monkeypatch):
    rng = np.random.default_rng(5)
    k, s = 31, 20
    B, L = 16, 256
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lens = rng.integers(100, L + 1, size=B).astype(np.int32)
    for i in range(B):
        codes[i, lens[i] :] = 4
    expect = nthash.khf_sketch_np_batch(codes, lens, k, s)
    monkeypatch.setenv("GROOT_DEVICE_SKETCH", "1")
    assert sketch_reads_u64(codes, lens, k, s) is None
    got = _join(*sketch_reads(codes, lens, k, s))
    assert (got == expect).all()
    monkeypatch.delenv("GROOT_DEVICE_SKETCH")
    assert (_join(*sketch_reads(codes, lens, k, s)) == expect).all()


def test_pallas_sketch_k51(monkeypatch):
    rng = np.random.default_rng(6)
    k, s = 51, 30
    codes = rng.integers(0, 4, size=(8, 128)).astype(np.uint8)
    lens = np.full(8, 100, np.int32)
    codes[:, 100:] = 4
    monkeypatch.setenv("GROOT_DEVICE_SKETCH", "1")
    got = _join(*sketch_reads(codes, lens, k, s))
    for i in range(8):
        golden = nthash.khf_sketch_np(codes[i, :100], k, s)
        assert (got[i] == golden).all()
