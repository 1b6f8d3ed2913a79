"""Edge-case behavior of the align pipeline, mirroring the reference's
fail-fast checks (src/pipeline/sketch.go): short reads error, empty input
errors, zero-mapping input empties the store and returns cleanly, and the
t=1.0 containment edge still maps perfect reads."""

import os

import numpy as np
import pytest

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.pipeline.align_pipeline import prune_graphs, run_align
from groot_tpu.pipeline.index_pipeline import run_index

TEST_DATA = "/root/reference/src/pipeline/test-data"
FASTQ = f"{TEST_DATA}/test-reads-OXA90-OXA106-100bp-with-errors.fastq"


@pytest.fixture(scope="module")
def oxa_index(tmp_path_factory, require_files):
    require_files(TEST_DATA)
    tmp = tmp_path_factory.mktemp("edges-idx")
    info = Info(
        kmer_size=51, sketch_size=30, window_size=100,
        index_dir=str(tmp / "index"),
    )
    run_index(info, TEST_DATA)
    return str(tmp / "index")


def load(oxa_index):
    info = Info.load(os.path.join(oxa_index, "groot.gg"))
    info.attach_db(
        ContainmentIndex.load(os.path.join(oxa_index, "groot.lshe"))
    )
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=10)
    return info


def write_fastq(path, reads):
    with open(path, "wb") as fh:
        for i, seq in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))


def test_read_shorter_than_k_errors(oxa_index, tmp_path):
    """sketch.go's FastqChecker fatals on len < k; same here."""
    info = load(oxa_index)
    fq = str(tmp_path / "short.fq")
    write_fastq(fq, [b"ACGT" * 10])  # 40bp < k=51
    with pytest.raises(ValueError, match="short than k-mer length"):
        run_align(info, [fq])


def test_empty_input_errors(oxa_index, tmp_path):
    info = load(oxa_index)
    fq = str(tmp_path / "empty.fq")
    open(fq, "wb").close()
    with pytest.raises(ValueError, match="no fastq reads received"):
        run_align(info, [fq])


def test_zero_mapping_reads_empty_store(oxa_index, tmp_path):
    """Random reads that never seed: exit cleanly with an emptied store
    (sketch.go:327-334's graceful no-results path)."""
    info = load(oxa_index)
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fq = str(tmp_path / "rand.fq")
    write_fastq(
        fq, [bases[rng.integers(0, 4, 100)].tobytes() for _ in range(64)]
    )
    stats = run_align(info, [fq])
    assert stats.received == 64
    assert stats.mapped == 0
    assert info.store == {}
    assert prune_graphs(info, 10.0) == []


def test_t_one_strict_inequality(oxa_index, tmp_path):
    """The containment filter is strictly `> t` like the reference
    (lshe.go:165): a perfect window copy has containment exactly 1.0, so
    it maps at any t < 1 but NOT at t = 1.0."""
    # take a perfect 100bp slice of a graph path as the read
    info = load(oxa_index)
    g = next(iter(info.store.values()))
    seq = next(iter(g.graph2seqs().values()))[:100]
    fq = str(tmp_path / "perfect.fq")
    write_fastq(fq, [seq])

    stats = run_align(info, [fq])  # default t=0.99
    assert (stats.received, stats.mapped) == (1, 1)

    info = load(oxa_index)
    info.containment_threshold = 1.0
    stats = run_align(info, [fq])
    assert (stats.received, stats.mapped) == (1, 0)
