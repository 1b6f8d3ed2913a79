import numpy as np

from groot_tpu.graph.grootgraph import GrootGraph
from groot_tpu.io.fastx import read_msa
from groot_tpu.io.gfa import parse_gfa, write_gfa
from groot_tpu.io.msa2gfa import msa_to_gfa

TEST_GFA = "/root/reference/src/graph/test.gfa"
TEST_MSA = "/root/reference/src/graph/test.msa"
TEST_GENES_MSA = "/root/reference/src/pipeline/test-data/test-genes.msa"

# blaB-10 linear sequence from the reference's graph test
# (/root/reference/src/graph/graph_test.go:18)
BLA_B10 = (
    b"ATGAAAGGATTAAAAGGGCTATTGGTTCTGGCTTTAGGCTTTACAGGACTACAGGTTTTTGGGCAACAGAA"
    b"CCCTGATATTAAAATTGAAAAATTAAAAGATAATTTATACGTCTATACAACCTATAATACCTTCAAAGGAA"
    b"CTAAATATGCGGCTAATGCGGTATATATGGTAACCGATAAAGGAGTAGTGGTTATAGACTCTCCATGGGGA"
    b"GAAGATAAATTTAAAAGTTTTACAGACGAGATTTATAAAAAGCACGGAAAGAAAGTTATCATGAACATTGC"
    b"AACCCACTCTCATGATGATAGAGCCGGAGGTCTTGAATATTTTGGTAAACTAGGTGCAAAAACTTATTCTA"
    b"CTAAAATGACAGATTCTATTTTAGCAAAAGAGAATAAGCCAAGAGCAAAGTACACTTTTGATAATAATAAA"
    b"TCTTTTAAAGTAGGAAAGACTGAGTTTCAGGTTTATTATCCGGGAAAAGGTCATACAGCAGATAATGTGGT"
    b"TGTGTGGTTTCCTAAAGACAAAGTATTAGTAGGAGGCTGCATTGTAAAAAGTGGTGATTCGAAAGACCTTG"
    b"GGTTTATTGGGGAAGCTTATGTAAACGACTGGACACAGTCCATACACAACATTCAGCAGAAATTTCCCTAT"
    b"GTTCAGTATGTCGTTGCAGGTCATGACGACTGGAAAGATCAAACATCAATACAACATACACTGGATTTAAT"
    b"CAGTGAATATCAACAAAAACAAAAGGCTTCAAATTAA"
)


def test_load_reference_gfa_fixture(require_files):
    """Parity with TestCreateGrootGraph (graph_test.go:58-67) and with the
    known blaB-10 linear sequence."""
    require_files(TEST_GFA)
    g = parse_gfa(TEST_GFA)
    assert len(g.segments) == 133
    assert len(g.links) == 176
    assert len(g.paths) == 6
    graph = GrootGraph.from_gfa(g, 1)
    seqs = graph.graph2seqs()
    names = {graph.paths[p]: p for p in graph.paths}
    b10 = seqs[names["*argannot~~~(Bla)B-10~~~AY348325:1-747"]]
    assert b10 == BLA_B10
    # path lengths match the sum of P-line segment lengths (note: the B-9
    # path in the fixture genuinely sums to 746 despite its ':1-747' name)
    seg_len = {s.name: len(s.sequence) for s in g.segments}
    for pid, p in enumerate(g.paths):
        assert graph.lengths[pid] == sum(seg_len[s] for s in p.segment_names)


def test_toposort_respects_path_order(require_files):
    require_files(TEST_GFA)
    g = parse_gfa(TEST_GFA)
    graph = GrootGraph.from_gfa(g, 1)
    # every path must traverse nodes in sorted-node order with correct
    # positions
    for pid in graph.paths:
        pos = 0
        for node in graph.sorted_nodes:
            if pid in node.path_ids:
                assert node.position[pid] == pos
                pos += len(node.sequence)
        assert pos == graph.lengths[pid]


def test_msa_to_gfa_roundtrip_sequences(require_files):
    """The degap invariant: every path's concatenated segments equal the
    ungapped MSA row."""
    require_files(TEST_MSA)
    rows = read_msa(TEST_MSA)
    g = msa_to_gfa(rows)
    # consensus dropped
    assert all(p.name != "consensus" for p in g.paths)
    assert len(g.paths) == 4
    graph = GrootGraph.from_gfa(g, 0)
    seqs = graph.graph2seqs()
    by_name = {graph.paths[p]: seqs[p] for p in graph.paths}
    for name, aligned in rows:
        if name == "consensus":
            continue
        assert by_name[name] == aligned.replace("-", "").upper().encode()


def test_msa_to_gfa_collapses_shared_columns():
    rows = [("s1", "ACGTA"), ("s2", "ACCTA"), ("consensus", "ACGTA")]
    g = msa_to_gfa(rows)
    # expect: shared "AC", variant {G, C}, shared "TA"
    seqs = [s.sequence for s in g.segments]
    assert seqs == ["AC", "G", "C", "TA"]
    assert [p.segment_names for p in g.paths] == [["1", "2", "4"], ["1", "3", "4"]]


def test_msa_to_gfa_gap_blocks():
    # s2 has a deletion spanning a variant block
    rows = [("s1", "AAATGTTTT"), ("s2", "AAA--TTTT")]
    g = msa_to_gfa(rows)
    graph = GrootGraph.from_gfa(g, 0)
    seqs = graph.graph2seqs()
    by_name = {graph.paths[p]: seqs[p] for p in graph.paths}
    assert by_name["s1"] == b"AAATGTTTT"
    assert by_name["s2"] == b"AAATTTT"


def test_gfa_write_parse_roundtrip(require_files):
    require_files(TEST_MSA)
    rows = read_msa(TEST_MSA)
    g = msa_to_gfa(rows)
    text = write_gfa(g)
    g2 = parse_gfa(text)
    assert [s.sequence for s in g2.segments] == [s.sequence for s in g.segments]
    assert [p.segment_names for p in g2.paths] == [
        p.segment_names for p in g.paths
    ]


def test_big_msa_builds(require_files):
    require_files(TEST_GENES_MSA)
    rows = read_msa(TEST_GENES_MSA)
    g = msa_to_gfa(rows)
    graph = GrootGraph.from_gfa(g, 0)
    assert len(graph.paths) == 81  # 82 rows - consensus
    seqs = graph.graph2seqs()
    by_name = {graph.paths[p]: seqs[p] for p in graph.paths}
    for name, aligned in rows:
        if name == "consensus":
            continue
        assert by_name[name] == aligned.replace("-", "").upper().encode()


def test_prune_and_weighting():
    rows = [("s1", "AAATGTTTT"), ("s2", "AAAC-TTTT")]
    g = msa_to_gfa(rows)
    graph = GrootGraph.from_gfa(g, 0)
    # weight all nodes of path s1 heavily, leave s2's unique branch at 0
    for node in graph.sorted_nodes:
        if 0 in node.path_ids:
            node.kmer_freq = 100.0 * len(node.sequence)
    assert graph.prune(1.0) is True
    kept = [graph.paths[p] for p in graph.paths if graph.lengths[p] > 0]
    assert kept == ["s1"]
    # prune dropping everything
    graph2 = GrootGraph.from_gfa(g, 0)
    assert graph2.prune(1.0) is False
