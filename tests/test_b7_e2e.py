"""The reference CI's end-to-end gate, scaled to test time.

Reference: /root/reference/testing/run_travis_tests.sh:8-60 — index arg-annot
at w=150 k=31 s=20, align bla-b7-150bp-5x.fq at t=0.99, report at c=0.97, and
require EXACTLY ONE reported ARG: argannot~~~(Bla)B-7~~~AF189304:1-747.

Tests use a 30-cluster subset of arg-annot.90 (including the B cluster and
every other cluster containing 'B-7' matches) so the suite stays fast; the
full-database run is exercised by bench.py / the verify drive.
"""

import glob
import os
import shutil
import subprocess
import sys
import tarfile

import pytest

B7 = "argannot~~~(Bla)B-7~~~AF189304:1-747"
READS = "/root/reference/testing/data/bla-b7-150bp-5x.fq"
DB_TAR = "/root/reference/db/clustered-ARG-databases/1.1/arg-annot.90.tar"


@pytest.fixture(scope="module")
def msa_subset(tmp_path_factory, require_files):
    require_files(DB_TAR, READS)
    tmp = tmp_path_factory.mktemp("argannot")
    with tarfile.open(DB_TAR) as tar:
        tar.extractall(tmp, filter="data")
    src = tmp / "arg-annot.90"
    sub = tmp / "subset"
    sub.mkdir()
    wanted = {f"cluster-{i}.msa" for i in range(1, 25)}
    wanted |= {
        "cluster-139.msa",  # the B cluster (B-5..B-10)
        "cluster-155.msa",
        "cluster-187.msa",
        "cluster-224.msa",
        "cluster-299.msa",
    }
    for name in wanted:
        p = src / name
        if p.exists():
            shutil.copy(p, sub / name)
    return str(sub)


def test_b7_travis_gate(msa_subset, tmp_path):
    from groot_tpu.config import AlignCmd, Info
    from groot_tpu.index.lshe import ContainmentIndex
    from groot_tpu.io import bam as bamio
    from groot_tpu.pipeline.align_pipeline import prune_graphs, run_align
    from groot_tpu.pipeline.index_pipeline import run_index
    from groot_tpu.report.pileup import report_from_bam

    index_dir = str(tmp_path / "index")
    info = Info(
        kmer_size=31,
        sketch_size=20,
        window_size=150,
        containment_threshold=0.99,
        index_dir=index_dir,
    )
    run_index(info, msa_subset)

    info = Info.load(os.path.join(index_dir, "groot.gg"))
    info.attach_db(ContainmentIndex.load(os.path.join(index_dir, "groot.lshe")))
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=1.0)
    bam_path = str(tmp_path / "groot.bam")
    refs = bamio.build_references(info.store)
    with open(bam_path, "wb") as fh:
        writer = bamio.BamWriter(fh, refs)
        stats = run_align(info, [READS], bam_writer=writer)
        writer.close()
    assert stats.mapped > 0
    prune_graphs(info, 1.0)

    annotations = report_from_bam(bam_path, coverage_cutoff=0.97)
    assert len(annotations) == 1, [a.arg for a in annotations]
    assert annotations[0].arg == B7
