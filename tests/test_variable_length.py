"""Variable read lengths through the device engine (r4 advisor finding).

The round-5 seed scan takes per-row read lengths (static anchor ladder +
dynamic tail anchor), so ONE compiled program serves a quality-trimmed
library's whole length mix; the r4 design compiled once per distinct
length. This test runs the reference's variable-read-length fixture
(testing/data/full-argannot-perfect-reads-small-variable-rl.fq.gz, 1000
perfect reads of ~50 distinct lengths in [50, 100] bp) through the host
and device engines against the full arg-annot.90 index and asserts
identical stats, BAM records (order-canonicalized) and graph weights —
on the 8-virtual-device mesh the conftest provides, so the sharded scan
is exercised with a ragged length mix too."""

import os
import tarfile

import numpy as np
import pytest

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.io import bam as bamio
from groot_tpu.pipeline.align_pipeline import run_align
from groot_tpu.pipeline.index_pipeline import run_index

DB_TAR = "/root/reference/db/clustered-ARG-databases/1.1/arg-annot.90.tar"
READS = (
    "/root/reference/testing/data/"
    "full-argannot-perfect-reads-small-variable-rl.fq.gz"
)


@pytest.fixture(scope="module")
def full_index(tmp_path_factory, require_files):
    """A ~40-cluster subset of arg-annot.90 (the full index's unfolded
    device table is 2.3 GB — too heavy for the CPU-backend test run);
    reads from other clusters simply don't map, and hundreds still do,
    across the whole length mix."""
    require_files(DB_TAR, READS)
    import shutil

    tmp = tmp_path_factory.mktemp("vrl-idx")
    with tarfile.open(DB_TAR) as tar:
        tar.extractall(tmp, filter="data")
    src = tmp / "arg-annot.90"
    sub = tmp / "subset"
    sub.mkdir()
    for i in range(1, 41):
        p = src / f"cluster-{i}.msa"
        if p.exists():
            shutil.copy(p, sub / p.name)
    index_dir = str(tmp / "index")
    info = Info(
        kmer_size=31,
        sketch_size=20,
        window_size=150,
        containment_threshold=0.99,
        index_dir=index_dir,
    )
    run_index(info, str(sub))
    return index_dir


def _run(full_index, tmp_path, engine):
    os.environ["GROOT_ENGINE"] = engine
    try:
        info = Info.load(os.path.join(full_index, "groot.gg"))
        info.attach_db(
            ContainmentIndex.load(os.path.join(full_index, "groot.lshe"))
        )
        info.containment_threshold = 0.99
        info.sketch = AlignCmd(min_kmer_coverage=1.0)
        bam_path = str(tmp_path / f"vrl-{engine}.bam")
        with open(bam_path, "wb") as fh:
            writer = bamio.BamWriter(fh, bamio.build_references(info.store))
            stats = run_align(
                info, [READS], bam_writer=writer, batch_size=256
            )
            writer.close()
        weights = np.array(
            [
                n.kmer_freq
                for _gid, g in sorted(info.store.items())
                for n in g.sorted_nodes
            ]
        )
        refs, recs = bamio.read_bam(bam_path)
        canon = sorted(
            (r.name, r.ref_id, r.pos, r.flag, r.seq_len, tuple(r.cigar))
            for r in recs
        )
        return stats, weights, canon
    finally:
        os.environ.pop("GROOT_ENGINE", None)


def test_variable_length_device_matches_host(full_index, tmp_path):
    import gzip

    lens = set()
    with gzip.open(READS, "rb") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                lens.add(len(line.strip()))
    assert len(lens) > 30, "fixture no longer has a rich length mix"

    s_host, w_host, bam_host = _run(full_index, tmp_path, "hash")
    s_dev, w_dev, bam_dev = _run(full_index, tmp_path, "device")
    assert s_host.mapped == s_dev.mapped > 0
    assert s_host.alignment_count == s_dev.alignment_count > 0
    assert bam_host == bam_dev
    np.testing.assert_allclose(w_host, w_dev)
