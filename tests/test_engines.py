"""The align engines on seeded synthetic data (groot_tpu.synth): every
engine variant must reproduce the legacy per-Key oracle (`host`) record for
record, on the 8-device CPU mesh the device engine shards its seed scan
over; plus engine choice, the compile-cache location and the batched EM
against its float64 reference."""

import os

import numpy as np
import pytest

from groot_tpu.config import AlignCmd, Info
from groot_tpu.index.lshe import ContainmentIndex
from groot_tpu.io import bam as bamio
from groot_tpu.pipeline.align_pipeline import (
    _select_engine,
    prune_graphs,
    run_align,
)
from groot_tpu.pipeline.index_pipeline import run_index

ENGINE_ENV = {
    "host": [("GROOT_ENGINE", "host")],
    "hash": [("GROOT_ENGINE", "hash")],
    "hash-np": [("GROOT_ENGINE", "hash"), ("GROOT_NO_NATIVE_CASCADE", "1")],
    "device": [("GROOT_ENGINE", "device")],
    "device-np": [
        ("GROOT_ENGINE", "device"), ("GROOT_NO_NATIVE_CASCADE", "1")
    ],
    "device-seq": [("GROOT_ENGINE", "device"), ("GROOT_SEQUENTIAL", "1")],
    "hash-nopre": [("GROOT_ENGINE", "hash"), ("GROOT_NO_PRESCREEN", "1")],
}


@pytest.fixture(scope="module")
def synth_index(synth_data, tmp_path_factory):
    index_dir = str(tmp_path_factory.mktemp("synth-idx") / "index")
    info = Info(
        kmer_size=31, sketch_size=20, window_size=150, index_dir=index_dir
    )
    run_index(info, synth_data.db.msa_dir)
    return index_dir


def _align(index_dir, reads, bam_path, engine, monkeypatch):
    for key, val in ENGINE_ENV[engine]:
        monkeypatch.setenv(key, val)
    try:
        info = Info.load(os.path.join(index_dir, "groot.gg"))
        info.attach_db(
            ContainmentIndex.load(os.path.join(index_dir, "groot.lshe"))
        )
        info.containment_threshold = 0.99
        info.sketch = AlignCmd(min_kmer_coverage=1.0)
        with open(bam_path, "wb") as fh:
            writer = bamio.BamWriter(fh, bamio.build_references(info.store))
            stats = run_align(info, [reads], bam_writer=writer, batch_size=128)
            writer.close()
        weights = {
            (gid, n.segment_id): n.kmer_freq
            for gid, g in info.store.items()
            for n in g.sorted_nodes
        }
        found = prune_graphs(info, 1.0)
    finally:
        for key, _val in ENGINE_ENV[engine]:
            monkeypatch.delenv(key)
    refs, recs = bamio.read_bam(bam_path)
    names = {r.ref_id: r.name for r in refs}
    canon = sorted(
        (r.name, names[r.ref_id], r.pos, r.flag, r.seq_len, tuple(r.cigar))
        for r in recs
    )
    return stats, weights, found, canon


@pytest.fixture(scope="module")
def host_run(synth_data, synth_index, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        bam = str(tmp_path_factory.mktemp("host") / "host.bam")
        return _align(synth_index, synth_data.dense_fastq, bam, "host", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize(
    "engine",
    ["hash", "hash-np", "device", "device-np", "device-seq", "hash-nopre"],
)
def test_engine_matches_host_oracle(
    synth_data, synth_index, host_run, tmp_path, monkeypatch, engine
):
    s_ref, w_ref, found_ref, canon_ref = host_run
    stats, weights, found, canon = _align(
        synth_index, synth_data.dense_fastq, str(tmp_path / "e.bam"),
        engine, monkeypatch,
    )
    assert stats.received == s_ref.received == synth_data.n_dense
    assert stats.mapped == s_ref.mapped > 0.9 * synth_data.n_dense
    assert stats.multimapped == s_ref.multimapped
    assert stats.alignment_count == s_ref.alignment_count == len(canon_ref)
    assert canon == canon_ref
    assert found == found_ref
    assert weights.keys() == w_ref.keys()
    for key, val in w_ref.items():
        assert weights[key] == pytest.approx(val), key


def test_synth_database_shape(synth_data):
    """The generator's own contract: named MSAs, >= 90% identity within a
    cluster, wildcard alleles, bbmap-style read names."""
    from groot_tpu.io.fastx import read_msa
    from groot_tpu.pipeline.index_pipeline import find_msa_files

    db = synth_data.db
    files = find_msa_files(db.msa_dir)
    assert len(files) == db.clusters == 6
    assert any(b"N" in a.seq for a in db.alleles)
    for path in files:
        rows = read_msa(path)
        mat = np.array([np.frombuffer(r.encode(), np.uint8) for _, r in rows])
        ident = (mat[:, None, :] == mat[None, :, :]).mean(axis=-1)
        assert ident.min() >= 0.9, path
    lens = [len(a.seq) for a in db.alleles]
    assert min(lens) >= 294 and max(lens) <= 3006
    with open(synth_data.dense_fastq, "rb") as fh:
        name = fh.readline()[1:].decode().strip().split("_")
    assert name[9] in {a.name for a in db.alleles}
    assert len(synth_data.planted) == 2


def test_auto_engine_is_device_on_gpu(monkeypatch):
    import jax

    monkeypatch.delenv("GROOT_ENGINE", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _select_engine() == "device"
    monkeypatch.setenv("GROOT_ENGINE", "hash")
    assert _select_engine() == "hash"


def test_auto_engine_is_hash_on_cpu(monkeypatch):
    import jax

    monkeypatch.setenv("GROOT_ENGINE", "auto")
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert _select_engine() == "hash"
    monkeypatch.setenv("GROOT_ENGINE", "device")
    assert _select_engine() == "device"


def test_unknown_engine_raises(monkeypatch):
    monkeypatch.setenv("GROOT_ENGINE", "cascade")
    with pytest.raises(ValueError, match="unknown GROOT_ENGINE"):
        _select_engine()


def _record_config(monkeypatch):
    import jax

    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda key, val: calls.__setitem__(key, val)
    )
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from groot_tpu import compile_cache

    calls = _record_config(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from groot_tpu import compile_cache

    calls = _record_config(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable() == want == compile_cache.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


def test_batched_em_matches_float64_reference():
    """The jitted float32 batched EM against the float64 NumPy loop on
    random equivalence classes: same iteration counts, alphas within 1e-4
    relative, the same paths above the 0.05 call share."""
    from groot_tpu.em.em import _run_em_batched, run_em_batched_np

    rng = np.random.default_rng(3)
    G, E, P = 12, 40, 9
    member = (rng.random((G, E, P)) < 0.3).astype(np.float32)
    n_paths = rng.integers(1, P + 1, size=G).astype(np.int32)
    member[:, np.arange(E), np.arange(E) % P] = 1.0
    member *= np.arange(P)[None, None, :] < n_paths[:, None, None]
    counts = rng.gamma(2.0, 5.0, size=(G, E)).astype(np.float32)
    counts[rng.random((G, E)) < 0.1] = 0.0
    it, alpha, _ = _run_em_batched(member, counts, n_paths, 5, 500)
    it_ref, alpha_ref = run_em_batched_np(member, counts, n_paths, 5, 500)
    alpha = np.asarray(alpha, np.float64)
    assert (np.asarray(it) == it_ref).all()
    np.testing.assert_allclose(alpha, alpha_ref, rtol=1e-4, atol=1e-6)
    share = alpha / alpha.sum(axis=1, keepdims=True)
    share_ref = alpha_ref / alpha_ref.sum(axis=1, keepdims=True)
    assert ((share >= 0.05) == (share_ref >= 0.05)).all()


def test_stage_times_tally_is_thread_safe(synth_index):
    """stage_times is fed from the dispatch thread and every collect
    worker: concurrent tallies must not lose updates."""
    import sys
    import threading

    from groot_tpu.align.device_join import DeviceJoinAligner

    info = Info.load(os.path.join(synth_index, "groot.gg"))
    al = DeviceJoinAligner(info.store, None)
    n_threads, n_iter = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [
                    al.tally({"combos": 1, "drain_s": 0.5})
                    for _ in range(n_iter)
                ]
            )
            for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert al.stage_times["combos"] == n_threads * n_iter
    assert al.stage_times["drain_s"] == 0.5 * n_threads * n_iter
