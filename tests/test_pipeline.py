"""End-to-end pipeline tests mirroring the reference's staged pipeline tests
(/root/reference/src/pipeline/2_index_test.go, 3_sketch_test.go): index the
OXA cluster MSA, align simulated error-containing OXA-90+OXA-106 reads and
assert the OXA-90 allele survives pruning. Shared params k=51 s=30 w=100
t=0.99 minKmerCov=10 (1_pipeline_test.go:32-55)."""

import os

import pytest

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.io import bam as bamio
from groot_tpu.pipeline.align_pipeline import prune_graphs, run_align, save_graphs
from groot_tpu.pipeline.index_pipeline import run_index

TEST_DATA = "/root/reference/src/pipeline/test-data"
FASTQ = f"{TEST_DATA}/test-reads-OXA90-OXA106-100bp-with-errors.fastq"
OXA90 = "argannot~~~(Bla)OXA-90~~~EU547443:1-825"


def make_info(tmp_path):
    return Info(
        num_proc=1,
        kmer_size=51,
        sketch_size=30,
        window_size=100,
        num_part=8,
        max_k=4,
        max_sketch_span=30,
        containment_threshold=0.99,
        index_dir=str(tmp_path / "index"),
    )


@pytest.fixture(scope="module")
def built_index(tmp_path_factory, require_files):
    require_files(TEST_DATA)
    tmp_path = tmp_path_factory.mktemp("idx")
    info = make_info(tmp_path)
    run_index(info, TEST_DATA)
    return str(tmp_path / "index")


def test_index_artifacts(built_index):
    assert os.path.exists(os.path.join(built_index, "groot.gg"))
    assert os.path.exists(os.path.join(built_index, "groot.lshe"))
    info = Info.load(os.path.join(built_index, "groot.gg"))
    assert len(info.store) == 1  # one MSA file -> one graph
    graph = info.store[0]
    assert len(graph.paths) == 81
    index = ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
    assert index.num_sketches > 0
    assert index.num_window_kmers == 100 - 51 + 1


def test_align_noalign_finds_oxa90(built_index, tmp_path):
    """3_sketch_test equivalent in --noAlign mode: weighting alone must keep
    the OXA-90 allele through pruning."""
    info = Info.load(os.path.join(built_index, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
    info.attach_db(index)
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=10, no_exact_align=True)
    stats = run_align(info, [FASTQ])
    assert stats.received == 2062
    assert stats.mapped > 0
    found = prune_graphs(info, info.sketch.min_kmer_coverage)
    assert OXA90 in found


@pytest.fixture(scope="module")
def aligned(built_index, tmp_path_factory):
    """Exact-align the OXA reads once; downstream stages share the result."""
    tmp = tmp_path_factory.mktemp("aligned")
    info = Info.load(os.path.join(built_index, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
    info.attach_db(index)
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=10, no_exact_align=False)
    bam_path = str(tmp / "out.bam")
    refs = bamio.build_references(info.store)
    with open(bam_path, "wb") as fh:
        writer = bamio.BamWriter(fh, refs)
        stats = run_align(info, [FASTQ], bam_writer=writer)
        writer.close()
    found = prune_graphs(info, info.sketch.min_kmer_coverage)
    gfa_dir = str(tmp / "graphs")
    save_graphs(info, gfa_dir, stats.total_kmers)
    return info, stats, found, bam_path, gfa_dir


def test_align_exact_finds_oxa90_and_writes_bam(aligned):
    """3_sketch_test equivalent with exact alignment + BAM output."""
    info, stats, found, bam_path, gfa_dir = aligned
    assert stats.alignment_count > 0
    assert OXA90 in found
    assert os.path.exists(os.path.join(gfa_dir, "groot-graph-0.gfa"))

    # BAM must be readable and contain records aligned to OXA-90
    read_refs, records = bamio.read_bam(bam_path)
    names = {r.ref_id: r.name for r in read_refs}
    count = 0
    oxa90_hits = 0
    for rec in records:
        count += 1
        assert 0 <= rec.pos < read_refs[rec.ref_id].length
        if names[rec.ref_id] == OXA90:
            oxa90_hits += 1
    assert count == stats.alignment_count
    assert oxa90_hits > 0


def test_report_from_oxa_bam(aligned):
    """Report stage on the OXA BAM: OXA-90 must be reported with full-ish
    coverage at the reference's default cutoff."""
    from groot_tpu.report.pileup import format_report, report_from_bam

    _, _, _, bam_path, _ = aligned
    annotations = report_from_bam(bam_path, coverage_cutoff=0.97)
    names = [a.arg for a in annotations]
    assert OXA90 in names
    text = format_report(annotations)
    row = [l for l in text.splitlines() if l.startswith(OXA90)][0]
    arg, count, length, cigar = row.split("\t")
    assert int(length) == 825
    assert int(count) > 0
    assert cigar.endswith("M") or "M" in cigar


def test_haplotype_calls_oxa90(aligned):
    """4_haplotype_test equivalent: EM on the weighted GFA calls OXA-90
    (cutoff=1.0, iterations 50..10000)."""
    from groot_tpu.config import HaploCmd
    from groot_tpu.pipeline.haplotype import find_haplotypes, load_weighted_gfas

    _, _, _, _, gfa_dir = aligned
    info = Info()
    info.haplotype = HaploCmd(cutoff=1.0, min_iterations=50, max_iterations=10000)
    graphs = load_weighted_gfas(
        info, [os.path.join(gfa_dir, "groot-graph-0.gfa")]
    )
    found = find_haplotypes(info, graphs)
    assert OXA90 in found


def test_run_align_setup_cache_reuse(built_index, tmp_path):
    """Repeated run_align calls on one loaded Info must reuse the cached
    aligner/tables (the ~0.25s sidecar load + table epilogue happens once)
    and keep producing identical BAM bytes."""
    info = Info.load(os.path.join(built_index, "groot.gg"))
    index = ContainmentIndex.load(os.path.join(built_index, "groot.lshe"))
    info.attach_db(index)
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=10, no_exact_align=False)

    def one_pass(name):
        bam_path = str(tmp_path / name)
        refs = bamio.build_references(info.store)
        with open(bam_path, "wb") as fh:
            writer = bamio.BamWriter(fh, refs)
            stats = run_align(info, [FASTQ], bam_writer=writer)
            writer.close()
        return stats, bamio.read_bam(bam_path)

    st1, (refs1, recs1) = one_pass("a.bam")
    rts = getattr(info, "_align_rt", None)
    assert rts  # per-engine runtime cache dict
    aligner_first = next(iter(rts.values()))[1]
    st2, (refs2, recs2) = one_pass("b.bam")
    assert (
        next(iter(info._align_rt.values()))[1] is aligner_first
    )  # cache hit, same aligner
    assert (st1.received, st1.mapped, st1.alignment_count) == (
        st2.received, st2.mapped, st2.alignment_count
    )
    assert [
        (r.ref_id, r.pos, r.flag, r.name, r.cigar) for r in recs1
    ] == [(r.ref_id, r.pos, r.flag, r.name, r.cigar) for r in recs2]

    # dump() must not try to serialise the runtime cache (it holds mmaps)
    info.dump(str(tmp_path / "roundtrip.gg"))
    assert getattr(info, "_align_rt", None) is not None
    reloaded = Info.load(str(tmp_path / "roundtrip.gg"))
    assert not hasattr(reloaded, "_align_rt")


def test_batched_em_equals_per_graph():
    """run_em_on_graphs (one padded jit call over the graph axis) must
    reproduce run_em_on_graph lane for lane — same iteration counts and
    alphas — including graphs of different ec/path shapes in one batch."""
    import copy

    import numpy as np

    from __graft_entry__ import _tiny_index
    from groot_tpu.em.em import run_em_on_graph, run_em_on_graphs

    info, _index = _tiny_index()
    graphs = list(info.store.values())
    rng = np.random.default_rng(9)
    for g in graphs:
        for node in g.sorted_nodes:
            node.kmer_freq = float(rng.integers(0, 500))
    singles = copy.deepcopy(graphs)
    for g in singles:
        run_em_on_graph(g, 10, 2000)
    run_em_on_graphs(graphs, 10, 2000)
    for g, s in zip(graphs, singles):
        assert g.em_iterations == s.em_iterations, g.graph_id
        assert set(g.alpha) == set(s.alpha)
        for pid, a in s.alpha.items():
            assert abs(g.alpha[pid] - a) <= 1e-5 * max(1.0, abs(a)), (
                g.graph_id, pid,
            )
