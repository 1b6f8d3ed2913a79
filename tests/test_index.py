import numpy as np
import pytest

from groot_tpu.config import Info
from groot_tpu.graph.grootgraph import GrootGraph
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.index.window import sketch_graph, window_sketches
from groot_tpu.io.fastx import read_msa
from groot_tpu.io.msa2gfa import msa_to_gfa
from groot_tpu.ops import nthash, u64

TEST_MSA = "/root/reference/src/graph/test.msa"


def build_graph(msa=TEST_MSA, gid=1):
    return GrootGraph.from_gfa(msa_to_gfa(read_msa(msa)), gid)


def test_window_sketches_match_per_window_golden():
    """Device sliding-min sketches == sketching each window separately."""
    k, s, w = 7, 16, 40
    rng = np.random.default_rng(7)
    lens = [80, 100]
    L = max(lens)
    codes = np.full((2, L), 4, dtype=np.uint8)
    for i, ln in enumerate(lens):
        codes[i, :ln] = rng.integers(0, 4, size=ln)
    hi, lo = window_sketches(codes, np.array(lens, dtype=np.int32), k, s, w)
    got = u64.to_np(np.asarray(hi), np.asarray(lo))
    for i, ln in enumerate(lens):
        for start in range(ln - w + 1):
            golden = nthash.khf_sketch_np(codes[i, start : start + w], k, s)
            assert (got[i, start] == golden).all(), (i, start)


def test_sketch_graph_windows(require_files):
    """WindowGraph parity checks on the MOX fixture (graph_test.go:75-96)."""
    require_files(TEST_MSA)
    graph = build_graph()
    w, k, s = 150, 7, 32
    lookup = sketch_graph(graph, w, k, s)
    assert graph.num_windows == sum(
        graph.lengths[p] - w + 1 for p in graph.paths
    )
    assert graph.num_distinct_sketches == sum(len(v) for v in lookup.values())
    assert graph.num_distinct_sketches > 0
    # every key's sketch matches a direct sketch of the window sequence
    seqs = graph.graph2seqs()
    checked = 0
    for key_base, keys in list(lookup.items())[:25]:
        for key in keys:
            pid = key.ref[0]
            node = graph.get_node(key.node)
            start = node.position[pid] + key.offset
            window_seq = seqs[pid][start : start + w]
            golden = nthash.khf_sketch_np(nthash.encode_seq(window_seq), k, s)
            assert (key.sketch == golden).all()
            # contained-node tallies sum to (merge_span+1) * window bases
            assert sum(key.contained_nodes.values()) >= w
            checked += 1
    assert checked > 0


def test_tail_run_dropped():
    """The reference drops each path's final merge-run unless it is the only
    run (graph.go:298-338)."""
    rows = [("s1", "ACGTACGGATCGATCGTACGATCGGATTACA")]
    graph = GrootGraph.from_gfa(msa_to_gfa(rows, drop_consensus=False), 0)
    w, k, s = 10, 5, 8
    lookup = sketch_graph(graph, w, k, s)
    n_emitted = sum(len(v) for v in lookup.values())
    # count distinct runs directly
    L = graph.lengths[0]
    seq = rows[0][1].encode()
    sketches = [
        tuple(nthash.khf_sketch_np(nthash.encode_seq(seq[i : i + w]), k, s))
        for i in range(L - w + 1)
    ]
    runs = 1 + sum(
        1 for a, b in zip(sketches, sketches[1:]) if a != b
    )
    if runs > 1:
        assert n_emitted == runs - 1
    else:
        assert n_emitted == 1


def test_lsh_query_finds_exact_windows(require_files):
    require_files(TEST_MSA)
    graph = build_graph()
    w, k, s = 100, 31, 21
    lookup = sketch_graph(graph, w, k, s)
    index = ContainmentIndex(
        num_part=8, max_k=4, num_window_kmers=w - k + 1, sketch_size=s
    )
    for key_base, keys in lookup.items():
        for i, key in enumerate(keys):
            index.add_window(f"{key_base}-{i}", key)
    index.prepare()

    # query with exact window sequences -> the right graph must be hit
    seqs = graph.graph2seqs()
    reads = []
    starts = [0, 250, 500, 777, 1052]
    for st in starts:
        reads.append(seqs[0][st : st + w])
    codes = np.stack([nthash.encode_seq(r) for r in reads])
    hi, lo = nthash.khf_sketch(codes, k, s)
    qsizes = np.full(len(reads), w - k + 1, dtype=np.int32)
    results = index.query_batch(np.asarray(hi), np.asarray(lo), qsizes, 0.99)
    n_hit = 0
    for st, res in zip(starts, results):
        if res:
            assert list(res.keys()) == [1]
            n_hit += 1
            for key in res[1]:
                assert 0 in key.ref or len(key.ref) > 0
    # most exact windows must seed (tail windows may be unindexed by the
    # reference's tail-run drop)
    assert n_hit >= 4

    # reverse complement of a window must seed identically (canonical hashing)
    rc = nthash.revcomp_codes(nthash.encode_seq(reads[1]))[None, :]
    hi2, lo2 = nthash.khf_sketch(rc, k, s)
    res_rc = index.query_batch(np.asarray(hi2), np.asarray(lo2), qsizes[:1], 0.99)
    assert res_rc[0] and list(res_rc[0].keys()) == [1]

    # random read must NOT seed
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 4, size=(1, w)).astype(np.uint8)
    hi3, lo3 = nthash.khf_sketch(rand, k, s)
    res_rand = index.query_batch(np.asarray(hi3), np.asarray(lo3), qsizes[:1], 0.99)
    assert res_rand[0] == {}


def test_index_serialisation_roundtrip(tmp_path, require_files):
    require_files(TEST_MSA)
    graph = build_graph()
    w, k, s = 100, 31, 21
    lookup = sketch_graph(graph, w, k, s)
    index = ContainmentIndex(
        num_part=8, max_k=4, num_window_kmers=w - k + 1, sketch_size=s
    )
    for key_base, keys in lookup.items():
        for i, key in enumerate(keys):
            index.add_window(f"{key_base}-{i}", key)
    p = str(tmp_path / "groot.lshe")
    index.dump(p)
    loaded = ContainmentIndex.load(p)
    assert loaded.num_sketches == index.num_sketches
    assert (loaded.sketches == np.stack([k_.sketch for k_ in index.keys])).all()

    # Info roundtrip with store
    info = Info(window_size=w, kmer_size=k, sketch_size=s)
    info.store = {graph.graph_id: graph}
    gg = str(tmp_path / "groot.gg")
    info.dump(gg)
    info2 = Info.load(gg)
    assert info2.window_size == w
    assert set(info2.store) == {graph.graph_id}
    assert info2.store[graph.graph_id].lengths == graph.lengths


def test_duplicate_window_key_rejected():
    index = ContainmentIndex(num_part=8, max_k=4, num_window_kmers=70, sketch_size=8)
    from groot_tpu.index.window import Key

    key = Key(0, 1, 0, {1: 1.0}, [0], np.zeros(8, dtype=np.uint64))
    index.add_window("g0n1o0-0", key)
    with pytest.raises(ValueError):
        index.add_window("g0n1o0-0", key)


def test_full_equality_query_fast_path_matches_banded():
    """At groot's standard t=0.99 with query size ~ window k-mers,
    containment > t requires all sketch slots equal, so the full-sketch
    hash join must return exactly the banded path's hit set."""
    import numpy as np

    from groot_tpu.index.lshe import ContainmentIndex
    from groot_tpu.index.window import Key

    rng = np.random.default_rng(13)
    s, d = 20, 120
    N = 500
    idx = ContainmentIndex(
        num_part=8, max_k=4, num_window_kmers=d, sketch_size=s
    )
    base = rng.integers(0, 2**63, size=(40, s), dtype=np.uint64)
    for i in range(N):
        sk = base[i % 40].copy()
        if i % 3 == 0:  # perturb some so not everything collides
            sk[i % s] ^= np.uint64(i + 1)
        idx.add_window(
            f"g{i}n0o0-0",
            Key(
                graph_id=i, node=0, offset=0, contained_nodes={0: 1.0},
                ref=[0], sketch=sk, merge_span=0, window_size=150,
            ),
        )
    idx.prepare()
    # queries: exact copies of indexed sketches + random misses
    q = np.concatenate([base[:20], rng.integers(0, 2**63, (20, s), np.uint64)])
    hi = (q >> np.uint64(32)).astype(np.uint32)
    lo = (q & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sizes = np.full(len(q), d, np.int32)
    r1, w1 = idx.query_batch_np(hi, lo, sizes, 0.99)
    r2, w2 = idx.query_batch_np(hi, lo, sizes, 0.99, force_banded=True)
    k1 = sorted(zip(r1.tolist(), w1.tolist()))
    k2 = sorted(zip(r2.tolist(), w2.tolist()))
    assert k1 == k2
    assert len(k1) > 0

    # the u64 entry (no hi/lo split) must return the same hit set, with
    # and without the prescreened flag; sentinel rows (slots 1.. all-ones,
    # as emitted by the slot-0 prescreen for reads that cannot seed) must
    # be skipped when prescreened=True
    r3, w3 = idx.query_batch_np(None, None, sizes, 0.99, q64=q)
    assert sorted(zip(r3.tolist(), w3.tolist())) == k1
    r4, w4 = idx.query_batch_np(
        None, None, sizes, 0.99, q64=q, prescreened=True
    )
    assert sorted(zip(r4.tolist(), w4.tolist())) == k1
    q_sent = q.copy()
    q_sent[:, 1:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    r5, _w5 = idx.query_batch_np(
        None, None, sizes, 0.99, q64=q_sent, prescreened=True
    )
    assert len(r5) == 0


def test_blocked_device_sketching_stitches_runs(monkeypatch):
    """The GROOT_DEVICE_SKETCH path splits rows into 1024-window column
    blocks with a (w-1) halo; its runs (incl. boundary stitching across
    blocks and repeat-induced merge runs) must match the host/numpy path
    exactly on rows much longer than one block."""
    from groot_tpu.index import window as win_mod

    rng = np.random.default_rng(21)
    w, k, s = 100, 31, 16
    # one long path (>2 blocks) with a repeated stretch to force merge runs
    seq = rng.integers(0, 4, size=2600, dtype=np.uint8)
    seq[1200:1450] = seq[0]  # constant stretch -> identical window runs
    row = "".join("ACGT"[b] for b in seq)
    seq2 = seq.copy()
    seq2[[400, 900, 1800, 2200]] = (seq2[[400, 900, 1800, 2200]] + 1) % 4
    row2 = "".join("ACGT"[b] for b in seq2)
    gfa = msa_to_gfa([("geneA", row), ("geneB", row2)], drop_consensus=False)

    monkeypatch.setenv("GROOT_DEVICE_SKETCH", "1")
    win_mod._device_check.clear()
    g_dev = GrootGraph.from_gfa(gfa, 5)
    res_dev = win_mod.sketch_graphs([g_dev], w, k, s)[0]

    monkeypatch.delenv("GROOT_DEVICE_SKETCH")
    g_host = GrootGraph.from_gfa(gfa, 5)
    res_host = win_mod.sketch_graphs([g_host], w, k, s)[0]

    assert set(res_dev) == set(res_host)
    assert g_dev.num_distinct_sketches == g_host.num_distinct_sketches
    for ks in res_host:
        assert len(res_dev[ks]) == len(res_host[ks])
        for kd, kh in zip(res_dev[ks], res_host[ks]):
            assert (kd.sketch == kh.sketch).all()
            assert kd.merge_span == kh.merge_span
            assert kd.contained_nodes == kh.contained_nodes
            assert kd.ref == kh.ref


def test_device_sketch_selfcheck_falls_back(monkeypatch):
    """A failing golden self-check must stop a device-sketched build with
    an error (never trust an unverified kernel silently, and never fall
    back to the host behind the caller's back); the host build of the same
    graph still works."""
    from groot_tpu.index import window as win_mod

    w, k, s = 100, 31, 16
    rng = np.random.default_rng(3)
    row = "".join("ACGT"[b] for b in rng.integers(0, 4, size=1500))
    gfa = msa_to_gfa([("geneA", row)], drop_consensus=False)

    monkeypatch.setenv("GROOT_DEVICE_SKETCH", "1")
    monkeypatch.setattr(
        win_mod, "_device_sketch_selfcheck", lambda *a: False
    )
    g1 = GrootGraph.from_gfa(gfa, 7)
    with pytest.raises(RuntimeError, match="self-check"):
        win_mod.sketch_graphs([g1], w, k, s)

    monkeypatch.delenv("GROOT_DEVICE_SKETCH")
    g2 = GrootGraph.from_gfa(gfa, 7)
    res_host = win_mod.sketch_graphs([g2], w, k, s)[0]
    assert g2.num_distinct_sketches == sum(len(v) for v in res_host.values())
    assert g2.num_distinct_sketches > 0
