"""The hash-join aligner (v5, the default) must reproduce the legacy
per-Key host path end to end: same stats, same node weights, same BAM
records (order-canonicalized)."""

import os

import pytest

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.io import bam as bamio
from groot_tpu.pipeline.align_pipeline import prune_graphs, run_align
from groot_tpu.pipeline.index_pipeline import run_index

TEST_DATA = "/root/reference/src/pipeline/test-data"
FASTQ = f"{TEST_DATA}/test-reads-OXA90-OXA106-100bp-with-errors.fastq"
OXA90 = "argannot~~~(Bla)OXA-90~~~EU547443:1-825"


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, require_files):
    require_files(TEST_DATA)
    tmp_path = tmp_path_factory.mktemp("idx")
    info = Info(
        kmer_size=51,
        sketch_size=30,
        window_size=100,
        containment_threshold=0.99,
        index_dir=str(tmp_path / "index"),
    )
    run_index(info, TEST_DATA)
    return str(tmp_path / "index")


def _run(built_index, tmp_path, engine: str):
    env = {
        "host": [("GROOT_ENGINE", "host")],
        "hash": [("GROOT_ENGINE", "hash")],
        "hash-np": [
            ("GROOT_ENGINE", "hash"), ("GROOT_NO_NATIVE_CASCADE", "1")
        ],
        "device": [("GROOT_ENGINE", "device")],
        "device-np": [
            ("GROOT_ENGINE", "device"), ("GROOT_NO_NATIVE_CASCADE", "1")
        ],
        "device-seq": [
            ("GROOT_ENGINE", "device"), ("GROOT_SEQUENTIAL", "1")
        ],
        "hash-nopre": [
            ("GROOT_ENGINE", "hash"), ("GROOT_NO_PRESCREEN", "1")
        ],
    }[engine]
    for k, v in env:
        os.environ[k] = v
    try:
        info = Info.load(os.path.join(built_index, "groot.gg"))
        info.attach_db(
            ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
        )
        info.containment_threshold = 0.99
        info.sketch = AlignCmd(min_kmer_coverage=10, no_exact_align=False)
        bam_path = str(tmp_path / f"out-{engine}.bam")
        refs = bamio.build_references(info.store)
        with open(bam_path, "wb") as fh:
            writer = bamio.BamWriter(fh, refs)
            stats = run_align(info, [FASTQ], bam_writer=writer)
            writer.close()
        weights = {
            n.segment_id: n.kmer_freq for n in info.store[0].sorted_nodes
        }
        kmer_total = info.store[0].kmer_total
        found = prune_graphs(info, 10)
        return stats, weights, kmer_total, found, bam_path
    finally:
        for k, _v in env:
            os.environ.pop(k, None)


def _bam_key_set(path):
    refs, records = bamio.read_bam(path)
    return sorted(
        (r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar))
        for r in records
    )


@pytest.mark.parametrize(
    "engine",
    ["hash", "hash-np", "device", "device-np", "device-seq", "hash-nopre"],
)
def test_hash_join_matches_legacy(built_index, tmp_path, engine):
    s_host, w_host, kt_host, found_host, bam_host = _run(
        built_index, tmp_path, "host"
    )
    s_hash, w_hash, kt_hash, found_hash, bam_hash = _run(
        built_index, tmp_path, engine
    )
    assert s_hash.received == s_host.received
    assert s_hash.mapped == s_host.mapped
    assert s_hash.multimapped == s_host.multimapped
    assert s_hash.alignment_count == s_host.alignment_count
    assert found_hash == found_host
    assert OXA90 in found_hash
    assert kt_hash == pytest.approx(kt_host)
    for seg, wv in w_host.items():
        assert w_hash[seg] == pytest.approx(wv), f"node {seg} weight mismatch"
    assert _bam_key_set(bam_hash) == _bam_key_set(bam_host)
