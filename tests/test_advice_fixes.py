"""Regression tests for the round-2 advisor findings (ADVICE.md):

1. groot.align sidecar must be rejected when it does not match the loaded
   groot.lshe index (fingerprint check).
2. A read longer than the setup-time rpow/rinv tables must not index out of
   bounds (long-read FASTQ batches grow the tables per batch).
3. BgzfWriter must surface a worker IO error as an exception instead of
   deadlocking on the full block queue.
"""

import os

import numpy as np
import pytest

from groot_tpu.config import Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.io import bam as bamio
from groot_tpu.pipeline.index_pipeline import run_index

TEST_DATA = "/root/reference/src/pipeline/test-data"


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, require_files):
    require_files(TEST_DATA)
    tmp_path = tmp_path_factory.mktemp("idx-advice")
    info = Info(
        kmer_size=51,
        sketch_size=30,
        window_size=100,
        containment_threshold=0.99,
        index_dir=str(tmp_path / "index"),
    )
    run_index(info, TEST_DATA)
    return str(tmp_path / "index")


def _make_aligner(built_index):
    from groot_tpu.align.batch_host import WindowTables
    from groot_tpu.align.hash_join import HashAligner

    info = Info.load(os.path.join(built_index, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
    info.attach_db(index)
    refs = bamio.build_references(info.store)
    aligner = HashAligner(info.store, refs)
    tables = WindowTables(index, info.store)
    aligner.attach_tables(tables, index, info.kmer_size)
    return info, index, aligner


def test_sidecar_fingerprint_rejects_stale(built_index, tmp_path):
    info, index, aligner = _make_aligner(built_index)
    cache = str(tmp_path / "groot.align")
    aligner.save_arrays(cache)

    fresh = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh.try_load(index, cache, info.kmer_size) is not None

    # same index, different k -> stale
    fresh2 = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh2.try_load(index, cache, info.kmer_size + 2) is None

    # perturbed index (as if rebuilt) -> stale
    index.sketches = index.sketches.copy()
    index.sketches[0, 0] ^= np.uint64(1)
    fresh3 = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh3.try_load(index, cache, info.kmer_size) is None

    # pre-fix npz sidecar (no magic, no fingerprint) -> stale
    with open(cache, "wb") as fh:
        np.savez(fh, path_len=np.arange(3))
    fresh4 = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh4.try_load(index, cache, info.kmer_size) is None


def test_long_read_batch_grows_rpow(built_index):
    """A batch wider than the setup-sized rpow tables must be processed
    without out-of-bounds indexing (native and numpy paths)."""
    from groot_tpu.align.batch_host import WeightAccumulator
    from groot_tpu.io.fastx import FastqRead
    from groot_tpu.pipeline.align_pipeline import AlignStats, _make_batch

    info, index, aligner = _make_aligner(built_index)
    acc = WeightAccumulator(aligner.tables)
    npow0 = len(aligner.rpow)
    L = npow0 + 512  # longer than the setup table
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(list(b"ACGT"), size=L).tolist())
    read = FastqRead(id=b"@longread", seq=seq, qual=b"I" * L)
    batch = _make_batch([read])

    # fabricate one LSH hit so the aligner actually runs its join
    rows = np.array([0], np.int64)
    wins = np.array([0], np.int64)
    combo_start = np.array([0], np.int64)
    kc = np.array([float(L - info.kmer_size + 1)])
    stats = AlignStats()
    aligner.process_batch(
        batch, rows, wins, combo_start, kc, acc, None, stats
    )
    assert len(aligner.rpow) >= batch.codes.shape[1] + 2
    # recurrence integrity across the growth boundary
    i = npow0 + 1
    expect = pow(0x9E3779B97F4A7C15, i, 1 << 64)
    assert int(aligner.rpow[i]) == expect


def test_sidecar_blob_base_is_64_aligned(built_index, tmp_path):
    """Round-3 advice: the mmap'ed array views must be truly 64-byte
    aligned, which requires the blob base (magic + 8 + header) to land on
    a 64-byte file offset."""
    import pickle
    import struct

    info, index, aligner = _make_aligner(built_index)
    cache = str(tmp_path / "groot.align")
    aligner.save_arrays(cache)
    with open(cache, "rb") as fh:
        magic = fh.read(len(aligner._SIDE_MAGIC))
        (hlen,) = struct.unpack("<q", fh.read(8))
        base = len(magic) + 8 + hlen
    assert base % 64 == 0
    fresh = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh.try_load(index, cache, info.kmer_size) is not None
    for name in fresh._ARRAYS:
        arr = getattr(fresh, name)
        if arr.nbytes:
            assert arr.ctypes.data % 64 == 0, name


def test_stale_sidecar_not_retained(built_index, tmp_path):
    """Round-3 advice: a fingerprint-mismatched sidecar must not leave its
    mmap attached to the aligner."""
    info, index, aligner = _make_aligner(built_index)
    cache = str(tmp_path / "groot.align")
    aligner.save_arrays(cache)
    fresh = _make_aligner(built_index)[2].__class__(info.store)
    assert fresh.try_load(index, cache, info.kmer_size + 2) is None
    assert getattr(fresh, "_side_mmap", None) is None


def test_info_load_migrates_num_proc(tmp_path):
    """Round-4 advice: unset num_proc (0/missing) resolves to the machine
    at load, but an EXPLICIT num_proc=1 (deliberate single-threading on a
    shared host) survives a dump/load round-trip."""
    info = Info(kmer_size=7, sketch_size=4, window_size=20)
    p = str(tmp_path / "groot.gg")
    info.dump(p)  # default num_proc=0 == unset
    assert Info.load(p).num_proc == (os.cpu_count() or 1)
    info.num_proc = 1
    info.dump(p)
    assert Info.load(p).num_proc == 1
    info.num_proc = 7
    info.dump(p)
    assert Info.load(p).num_proc == 7


def test_bgzf_writer_error_propagates():
    class FailingFH:
        def write(self, data):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

    w = bamio.BgzfWriter(FailingFH())
    blob = b"x" * 0xFF00
    with pytest.raises(OSError):
        # enough blocks to overfill the 8-slot queue: must raise, not hang
        for _ in range(32):
            w.write(blob)
        w.close()
