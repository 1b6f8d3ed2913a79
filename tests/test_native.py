"""Native IO runtime tests: the C++ scanner/encoder/BGZF must agree with the
pure-Python paths bit for bit."""

import gzip

import numpy as np
import pytest

from groot_tpu.io import native
from groot_tpu.io.fastx import stream_fastq
from groot_tpu.ops.nthash import ASCII_TO_CODE

FASTQ = (
    "/root/reference/src/pipeline/test-data/"
    "test-reads-OXA90-OXA106-100bp-with-errors.fastq"
)


def test_native_builds():
    assert native.available(), "native lib should build in this image"


def test_parse_matches_python(require_files):
    require_files(FASTQ)
    buf = open(FASTQ, "rb").read()
    io_, il, so, sl, qo, ql, consumed = native.parse_fastq_buffer(buf)
    reads = list(stream_fastq([FASTQ]))
    assert len(io_) == len(reads) == 2062
    for i in (0, 1, 1000, 2061):
        assert buf[io_[i] : io_[i] + il[i]] == reads[i].id
        assert buf[so[i] : so[i] + sl[i]] == reads[i].seq
        assert buf[qo[i] : qo[i] + ql[i]] == reads[i].qual
    assert consumed <= len(buf)

    # numpy fallback agrees with native
    out_np = native._parse_fastq_np(buf, 1 << 30)
    for a, b in zip((io_, il, so, sl, qo, ql), out_np[:6]):
        assert (a == b).all()


def test_parse_partial_record(require_files):
    require_files(FASTQ)
    buf = open(FASTQ, "rb").read()
    cut = buf[: len(buf) - 37]  # truncate mid-record
    io_, *_rest, consumed = native.parse_fastq_buffer(cut)
    assert len(io_) == 2061
    assert consumed < len(cut)


def test_parse_rejects_bad_id():
    with pytest.raises(ValueError):
        native.parse_fastq_buffer(b"no_at_sign\nACGT\n+\nIIII\n")


def test_encode_matches_python():
    buf = b"@r1\nACGTNacgtnXX\n+\nIIIIIIIIIIII\n"
    io_, il, so, sl, qo, ql, _ = native.parse_fastq_buffer(buf)
    codes = native.encode_batch(buf, so, sl, 16)
    expect = np.full((1, 16), 4, np.uint8)
    expect[0, :12] = ASCII_TO_CODE[
        np.frombuffer(b"ACGTNacgtnXX", np.uint8)
    ]
    assert (codes == expect).all()


def test_bgzf_block_roundtrip():
    data = b"groot" * 1000
    block = native.bgzf_block(data)
    if block is None:
        pytest.skip("native lib unavailable")
    assert gzip.decompress(block) == data
    # BC extra field encodes block size
    assert block[12:14] == b"BC"


def test_native_sketch_matches_numpy_batch():
    from groot_tpu.io import native
    from groot_tpu.ops import nthash

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    B, L, k, s = 32, 128, 31, 20
    codes = rng.integers(0, 5, (B, L), dtype=np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int64)
    out = native.sketch(codes, lens, k, s)
    ref = nthash.khf_sketch_np_batch(codes, lens, k, s)
    np.testing.assert_array_equal(out, ref)


def test_native_window_sketch_matches_golden():
    """The C all-windows sketcher must produce the same run starts and
    sketches as the per-window numpy golden."""
    from groot_tpu.io import native
    from groot_tpu.ops import nthash

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    k, s, w = 7, 8, 20
    R, L = 6, 90
    codes = rng.integers(0, 4, (R, L), dtype=np.uint8)
    # force repeated windows so run detection actually triggers
    codes[2, 10:40] = codes[2, 10]
    lens = rng.integers(w, L + 1, R).astype(np.int64)
    res = native.window_sketch(codes, lens, k, s, w)
    assert res is not None
    rows, cols, sk, row_counts = res
    base = 0
    for r in range(R):
        nw = int(lens[r]) - w + 1
        prev = None
        exp_cols, exp_sks = [], []
        for i in range(nw):
            skt = nthash.khf_sketch_np(codes[r, i : i + w], k, s)
            if prev is None or (skt != prev).any():
                exp_cols.append(i)
                exp_sks.append(skt)
            prev = skt
        n = int(row_counts[r])
        assert n == len(exp_cols)
        np.testing.assert_array_equal(cols[base : base + n], exp_cols)
        np.testing.assert_array_equal(sk[base : base + n], np.stack(exp_sks))
        base += n


def test_sketch_slot0_prescreen_exact():
    """With a slot-0 prescreen, reads whose slot-0 min-hash is present get
    their FULL sketch bit-identically; absent reads get sentinel slots
    (which can never pass an all-slot-equality query)."""
    import numpy as np

    from groot_tpu.io import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (128, 160), np.uint8)
    vl = np.full(128, 151, np.int64)
    full = native.sketch(codes, vl, 31, 16)
    s0 = np.unique(full[::3, 0])  # every third read passes
    pref = native._prefix16(s0)
    pre = native.sketch(codes, vl, 31, 16, prescreen=(s0, pref))
    passed = np.isin(full[:, 0], s0)
    assert passed.sum() >= 128 // 3
    assert (pre[passed] == full[passed]).all()
    assert (pre[:, 0] == full[:, 0]).all()
    assert (
        pre[~passed][:, 1:] == np.uint64(0xFFFFFFFFFFFFFFFF)
    ).all()


def test_gunzip_whole_file_matches_zlib(synth_data):
    data = open(synth_data.dense_fastq, "rb").read()
    gz = gzip.compress(data)
    raw = native.gunzip(gz)
    if raw is None:  # built without libdeflate
        return
    assert raw.tobytes() == data
    # concatenated members (bgzip-style layout)
    raw2 = native.gunzip(gz + gz)
    assert raw2 is not None and raw2.tobytes() == data + data
    assert native.gunzip(b"\x1f\x8b" + b"\x00" * 64) is None


def test_batch_reads_native_gz_paths_agree(tmp_path, monkeypatch,
                                           synth_data):
    """The three .gz ingest routes (native whole-file gunzip, streaming
    zlib fallback, plain file) must produce identical batches."""
    import numpy as np

    from groot_tpu.pipeline.align_pipeline import batch_reads_native

    data = open(synth_data.dense_fastq, "rb").read()
    plain = tmp_path / "r.fq"
    plain.write_bytes(data)
    gz = tmp_path / "r.fq.gz"
    gz.write_bytes(gzip.compress(data))

    def collect(path):
        out = []
        for b in batch_reads_native([str(path)], batch_size=64):
            for i in range(b.n):
                r = b.read(i)
                out.append((r.id, r.seq, r.qual))
            out.append(
                (b.codes.tobytes(), np.asarray(b.lengths).tobytes())
            )
        return out

    want = collect(plain)
    assert collect(gz) == want
    monkeypatch.setenv("GROOT_GUNZIP_MAX_MB", "0")  # force streaming zlib
    assert collect(gz) == want
