"""ctypes bindings for the native IO runtime (native/grootio.cpp).

Builds the shared library on first use (g++ is in the image); every entry
point has a pure-Python/NumPy fallback so the framework works without a
compiler. `available()` reports which path is active."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("groot")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libgrootio.so"))
_lib: Optional[ctypes.CDLL] = None
_tried = False

_LONG = ctypes.c_long
_LP = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    """Run make under an exclusive lock: processes that start together
    (parallel test workers) compile once, the rest find it fresh."""
    import fcntl

    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-s", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        return os.path.exists(_LIB_PATH)
    except Exception as e:  # pragma: no cover
        log.warning("native build failed: %s", e)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # always run make: the library is built from source on first use, and
    # rebuilt when grootio.cpp is newer (a stale binary would silently
    # serve old code)
    if not _build() and not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gio_parse_fastq.restype = _LONG
        lib.gio_parse_fastq.argtypes = [
            ctypes.c_char_p, _LONG, _LONG, _LP, _LP, _LP, _LP, _LP, _LP,
            ctypes.POINTER(_LONG),
        ]
        lib.gio_encode.restype = None
        lib.gio_encode.argtypes = [ctypes.c_char_p, _LP, _LP, _LONG, _LONG, _U8P]
        lib.gio_bgzf_block.restype = _LONG
        lib.gio_bgzf_block.argtypes = [
            ctypes.c_char_p, _LONG, _U8P, _LONG,
        ]
        _U16P = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
        _I32Pb = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.gio_bam_scan.restype = _LONG
        lib.gio_bam_scan.argtypes = [
            _U8P, _LONG, _LONG, _I32Pb, _I32Pb, _U16P, _I32Pb, _LONG,
        ]
        lib.gio_bgzf_many.restype = _LONG
        lib.gio_bgzf_many.argtypes = [
            ctypes.c_char_p, _LONG, _LONG, _U8P, _LONG,
        ]
        lib.gio_inflate_blocks.restype = _LONG
        lib.gio_inflate_blocks.argtypes = [
            ctypes.c_char_p, _LP, _LP, _LP, _LONG, _U8P,
        ]
        if hasattr(lib, "gio_gunzip"):
            lib.gio_gunzip.restype = _LONG
            lib.gio_gunzip.argtypes = [ctypes.c_char_p, _LONG, _U8P, _LONG]
        _I8P = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
        _I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        _U64Pc = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        lib.gio_cascade.restype = _LONG
        lib.gio_cascade.argtypes = [
            _LONG, _LP, _LP, _LP, _LP, _U8P,         # combos
            _I8P, _I32P, _I32P,                       # matches
            _LP, _I32P, _I32P, _LP, _I32P,            # per-pair seed data
            _LP,                                      # cn_grow
            _LP, _I32P, _LP, _I32P, _I32P,            # node lookup
            ctypes.c_int,                             # n_shuffles
            _LP, _U8P, _LONG, _LP,                    # c_read codes stride len
            _I32P,                                    # ph_row remap
            _U64Pc, _U64Pc,                           # phf phr
            _U64Pc, _U64Pc, _LP,                      # rinv ph ph_start
            _I32P, _U8P, _U8P, _U8P, _LP,             # plen tfree nrow flat
            _I32P, _I8P, _I8P,                        # combo outputs
            _I32P, _I32P, _I32P, _LONG,               # ids out
        ]
        _U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        lib.gio_sketch.restype = None
        lib.gio_sketch.argtypes = [
            _U8P, _LONG, _LONG, _LP, _LONG, _LONG, _U64P,
            _LONG, _U64P, np.ctypeslib.ndpointer(
                dtype=np.int32, flags="C_CONTIGUOUS"
            ),
        ]
        _I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        _I8P_ = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
        _I32P_ = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.gio_find_matches.restype = _LONG
        lib.gio_find_matches.argtypes = [
            _U8P, _LONG, _LONG, _LP, _LONG,          # reads
            _LONG, _LP, _LP,                          # combos
            _I32P_,                                   # ph_row remap
            _U64P, _U64P,                             # phf phr outputs
            _U64P, _U64P, _U64P, _LP,                 # rpow rinv ph ph_start
            _I32P_, _LP, _U8P, _U8P, _U8P, _I32P_,    # path data
            _LONG, _U64P, _I32P_, _I32P_,             # anchors
            _LONG, _U64P, _I32P_, _I32P_, _I8P_,      # mini
            _I32P_, _I32P_,                           # prefix bucket indexes
            _U64P, _U64P,                             # len_mix g_mix
            _LONG, _LP, _I32P_, _I32P_,               # npos
            _LONG,                                    # G
            _LP, _I8P_, _I32P_, _I32P_, _I64P, _LONG,  # out
        ]
        lib.gio_window_sketch.restype = _LONG
        lib.gio_window_sketch.argtypes = [
            _U8P, _LONG, _LONG, _LP, _LONG, _LONG, _LONG,
            _I32P, _I32P, _U64P, _LONG, _LP,
        ]
        lib.gio_verify.restype = None
        lib.gio_verify.argtypes = [
            _LONG, _LP, _I8P, _LP, _LP,
            _U8P, _U8P, _LONG, _LONG, _LP,
            _I32P, _LP, _U8P, _U8P, _U8P,
        ]
        lib.gio_gather_bytes.restype = None
        lib.gio_gather_bytes.argtypes = [
            ctypes.c_char_p, _LONG, _LP, _LP, _LP, _U8P,
        ]
        _F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        _U64P_ = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        _U32P_ = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        _I32Pq = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        _I64Pq = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        lib.gio_lsh_query_full32.restype = _LONG
        lib.gio_lsh_query_full32.argtypes = [
            _U32P_, _U32P_, _LONG, _LONG,
            _F64P, ctypes.c_double, ctypes.c_double,
            _U32P_, _I32Pq, _I64Pq, _U64P_,
            _LP, _LP, _LONG,
        ]
        lib.gio_lsh_query_full64.restype = _LONG
        lib.gio_lsh_query_full64.argtypes = [
            _U64P_, _LONG, _LONG,
            _F64P, ctypes.c_double, ctypes.c_double,
            _U32P_, _I32Pq, _I64Pq, _U64P_,
            _LONG,
            _LP, _LP, _LONG,
        ]
        lib.gio_weight_pairs.restype = None
        lib.gio_weight_pairs.argtypes = [
            _LONG, _LP, _F64P,
            _LP, _I32Pq, _LP, _F64P,
            _U8P, _I32Pq, _F64P, _F64P,
        ]
        _I16P = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
        lib.gio_emit_records.restype = _LONG
        lib.gio_emit_records.argtypes = [
            _LONG,
            _U8P, _LP, _LP,          # id
            _U8P, _LP, _LP,          # seq
            _U8P, _LP, _LP,          # qual
            _U8P, _I16P, _I16P,      # rev cs ce
            _LP,                     # group_ptr
            _I32P, _LP,              # per-record ref_id, pos
            _U8P, _LONG,             # out
        ]
        lib.gio_dev_reduce.restype = None
        lib.gio_dev_reduce.argtypes = [
            _I32P, _I64Pq, _LONG, _I64Pq, _U8P, _U8P,
        ]
        lib.gio_dev_ids.restype = _LONG
        lib.gio_dev_ids.argtypes = [
            _I32P, _I64Pq, _I32Pq, _I32Pq, _LONG,
            _U8P, _U8P, _U8P, _I64Pq, _I64Pq,
            _I64Pq, _I64Pq, _I64Pq,
        ]
        lib.gio_s2_enum.restype = _LONG
        lib.gio_s2_enum.argtypes = [
            _LONG, _U64P_, _U64P_, _I64Pq,
            _LONG, _U64P_, _I32Pq, _I32Pq, _I32Pq, _LONG,
            _I32Pq, _I64Pq, _U64P_, _U64P_,
            _I64Pq, _I64Pq, _I64Pq, _LONG,
        ]
        lib.gio_s2_decide.restype = _LONG
        lib.gio_s2_decide.argtypes = [
            _LONG, _I64Pq, _I64Pq,
            _I64Pq, _I64Pq, _I64Pq,
            _I64Pq, _I32Pq, _I64Pq,
            _I64Pq, _I32Pq, _I64Pq, _I32Pq, _LONG, _I32Pq, _LONG,
            _I64Pq,
            _I64Pq, _I64Pq, _I64Pq, _I64Pq,
        ]
        _U32P = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        lib.gio_bam_fill.restype = None
        lib.gio_bam_fill.argtypes = [
            _LONG, _LP, _U32P,
            _LP, _LP, _U8P,
            _U32P, _U8P,
            _LP, _LP, _U8P,
            _LP, _LP, _U8P,
            _U8P,
        ]
        lib.gio_deflate_lib.restype = ctypes.c_char_p
        lib.gio_deflate_lib.argtypes = []
        _lib = lib
    except (OSError, AttributeError) as e:  # pragma: no cover
        # AttributeError: a stale .so missing a newly-added symbol (e.g.
        # make failed but an old binary remains) — fall back to Python
        # rather than crash at the first native wrapper call
        log.warning("native library unavailable, using Python paths: %s", e)
    return _lib


def available() -> bool:
    return _load() is not None


def deflate_lib() -> Optional[str]:
    """The deflate library the native build links ("libdeflate" or
    "zlib"), or None without the native library."""
    lib = _load()
    return None if lib is None else lib.gio_deflate_lib().decode()


def _buf_ptr(buf):
    """A c_char_p view of any bytes-like object's data. bytes pass through
    (ctypes takes the pointer directly); memoryview/mmap windows go through
    a zero-copy numpy view — the caller must keep ``buf`` alive for the
    duration of the native call."""
    if isinstance(buf, bytes):
        return buf
    a = np.frombuffer(buf, np.uint8)
    return ctypes.cast(a.ctypes.data, ctypes.c_char_p)


def parse_fastq_buffer(
    buf: bytes, max_reads: int = 1 << 30
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Parse a FASTQ byte buffer -> (id_off, id_len, seq_off, seq_len,
    qual_off, qual_len, consumed). Uses the native scanner when available."""
    lib = _load()
    if lib is not None:
        cap = min(max_reads, max(len(buf) // 8, 16))
        id_off = np.empty(cap, np.int64)
        id_len = np.empty(cap, np.int64)
        seq_off = np.empty(cap, np.int64)
        seq_len = np.empty(cap, np.int64)
        qual_off = np.empty(cap, np.int64)
        qual_len = np.empty(cap, np.int64)
        consumed = _LONG(0)
        n = lib.gio_parse_fastq(
            _buf_ptr(buf), len(buf), cap, id_off, id_len, seq_off, seq_len,
            qual_off, qual_len, ctypes.byref(consumed),
        )
        if n < 0:
            raise ValueError("read ID in fastq file does not begin with @")
        return (
            id_off[:n], id_len[:n], seq_off[:n], seq_len[:n],
            qual_off[:n], qual_len[:n], int(consumed.value),
        )
    # numpy fallback
    return _parse_fastq_np(buf, max_reads)


def _parse_fastq_np(buf: bytes, max_reads: int):
    arr = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl) // 4 * 4
    n = min(n_lines // 4, max_reads)
    if n == 0:
        return (np.empty(0, np.int64),) * 6 + (0,)
    starts = np.concatenate([[0], nl[: 4 * n - 1] + 1]).reshape(n, 4)
    ends = nl[: 4 * n].reshape(n, 4).copy()
    # trim \r
    for c in range(4):
        cr = arr[np.clip(ends[:, c] - 1, 0, None)] == 13
        ends[:, c] -= cr.astype(np.int64)
    if (arr[starts[:, 0]] != ord("@")).any():
        raise ValueError("read ID in fastq file does not begin with @")
    consumed = int(nl[4 * n - 1] + 1)
    return (
        starts[:, 0].astype(np.int64),
        (ends[:, 0] - starts[:, 0]).astype(np.int64),
        starts[:, 1].astype(np.int64),
        (ends[:, 1] - starts[:, 1]).astype(np.int64),
        starts[:, 3].astype(np.int64),
        (ends[:, 3] - starts[:, 3]).astype(np.int64),
        consumed,
    )


def encode_batch(
    buf: bytes, seq_off: np.ndarray, seq_len: np.ndarray, stride: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Encode sequences into a padded uint8 code matrix [n, stride].
    ``out`` (a C-contiguous uint8 [n, stride] view, e.g. a row slice of a
    preallocated batch matrix) avoids the allocate-then-concatenate copy
    when a batch spans several scanner segments."""
    n = len(seq_off)
    if out is None:
        out = np.empty((n, stride), np.uint8)
    assert out.shape == (n, stride) and out.flags["C_CONTIGUOUS"]
    lib = _load()
    if lib is not None:
        lib.gio_encode(
            _buf_ptr(buf),
            np.ascontiguousarray(seq_off, np.int64),
            np.ascontiguousarray(seq_len, np.int64),
            n,
            stride,
            out,
        )
        return out
    from ..ops.nthash import ASCII_TO_CODE

    out.fill(4)
    arr = np.frombuffer(buf, np.uint8)
    for r in range(n):
        ln = min(int(seq_len[r]), stride)
        o = int(seq_off[r])
        out[r, :ln] = ASCII_TO_CODE[arr[o : o + ln]]
    return out


def cascade(
    c_mlo, c_mcnt, c_pair_start, c_pair_cnt, c_fb,
    m_var, m_row, m_pos,
    p_seed_grow, p_off, p_span, p_cn_ptr, p_cn_cnt, cn_grow,
    node_base, node_g, g_first_row, npos_dense, node_len,
    n_shuffles: int,
    c_read, codes, lengths, ph_row, phf_all, phr_all,
    rinv, ph, ph_start, path_len, tfree, nrow, flat_codes, flat_start,
    id_cap: int,
):
    """Native staged-winner evaluation (see native/grootio.cpp gio_cascade);
    stages 3/4 probe clip variants lazily via the per-read prefix hashes.
    Returns (combo_win, combo_ori, combo_stage, id_combo, id_row, id_pos)
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_cascade"):
        return None
    nc = len(c_mlo)
    combo_win = np.empty(nc, np.int32)
    combo_ori = np.empty(nc, np.int8)
    combo_stage = np.empty(nc, np.int8)
    cap = max(id_cap, 1)
    out_combo = np.empty(cap, np.int32)
    out_row = np.empty(cap, np.int32)
    out_pos = np.empty(cap, np.int32)
    codes = np.ascontiguousarray(codes, np.uint8)
    n = lib.gio_cascade(
        nc,
        np.ascontiguousarray(c_mlo, np.int64),
        np.ascontiguousarray(c_mcnt, np.int64),
        np.ascontiguousarray(c_pair_start, np.int64),
        np.ascontiguousarray(c_pair_cnt, np.int64),
        np.ascontiguousarray(c_fb, np.uint8),
        np.ascontiguousarray(m_var, np.int8),
        np.ascontiguousarray(m_row, np.int32),
        np.ascontiguousarray(m_pos, np.int32),
        np.ascontiguousarray(p_seed_grow, np.int64),
        np.ascontiguousarray(p_off, np.int32),
        np.ascontiguousarray(p_span, np.int32),
        np.ascontiguousarray(p_cn_ptr, np.int64),
        np.ascontiguousarray(p_cn_cnt, np.int32),
        np.ascontiguousarray(cn_grow, np.int64),
        np.ascontiguousarray(node_base, np.int64),
        np.ascontiguousarray(node_g, np.int32),
        np.ascontiguousarray(g_first_row, np.int64),
        np.ascontiguousarray(npos_dense, np.int32),
        np.ascontiguousarray(node_len, np.int32),
        n_shuffles,
        np.ascontiguousarray(c_read, np.int64),
        codes, codes.shape[1],
        np.ascontiguousarray(lengths, np.int64),
        np.ascontiguousarray(ph_row, np.int32),
        phf_all, phr_all,
        np.ascontiguousarray(rinv, np.uint64),
        np.ascontiguousarray(ph, np.uint64),
        np.ascontiguousarray(ph_start, np.int64),
        np.ascontiguousarray(path_len, np.int32),
        np.ascontiguousarray(tfree, np.uint8),
        np.ascontiguousarray(nrow, np.uint8),
        np.ascontiguousarray(flat_codes, np.uint8),
        np.ascontiguousarray(flat_start, np.int64),
        combo_win, combo_ori, combo_stage,
        out_combo, out_row, out_pos, cap,
    )
    if n > cap:
        return None  # id overflow: numpy fallback
    return (
        combo_win, combo_ori, combo_stage,
        out_combo[:n].astype(np.int64),
        out_row[:n],
        out_pos[:n],
    )


_EMPTY_U64 = np.empty(0, np.uint64)
_EMPTY_I32 = np.empty(1, np.int32)


def sketch(codes, valid_len, k: int, s: int, prescreen=None):
    """Native canonical ntHash KHF sketching -> u64 [B, s]; None if the
    library is unavailable. `prescreen` = (s0_sorted u64, s0_pref i32)
    from ContainmentIndex.slot0_prescreen(): valid ONLY when the query
    will require all-slot equality (t=0.99 full-equality mode) — reads
    whose slot-0 min-hash is absent from the index skip the other s-1
    multihash passes and get sentinel slots."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_sketch"):
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    B, L = codes.shape
    out = np.empty((B, s), np.uint64)
    if prescreen is not None:
        s0_sorted, s0_pref = prescreen
        n_s0 = len(s0_sorted)
    else:
        s0_sorted, s0_pref, n_s0 = _EMPTY_U64, _EMPTY_I32, 0
    lib.gio_sketch(
        codes, B, L, np.ascontiguousarray(valid_len, np.int64), k, s, out,
        n_s0, s0_sorted, s0_pref,
    )
    return out


def window_sketch(codes, lens, k: int, s: int, w: int):
    """Native all-windows KHF sketching with run detection. Returns
    (rows, cols, sketches u64 [M, s], row_counts) of the run starts, or
    None when the library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_window_sketch"):
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    R, L = codes.shape
    lens = np.ascontiguousarray(lens, np.int64)
    cap = int(np.maximum(lens - w + 1, 0).sum()) + 1  # exact upper bound
    out_row = np.empty(cap, np.int32)
    out_col = np.empty(cap, np.int32)
    out_sk = np.empty((cap, s), np.uint64)
    row_counts = np.empty(R, np.int64)
    n = lib.gio_window_sketch(
        codes, R, L, lens, k, s, w, out_row, out_col, out_sk, cap, row_counts
    )
    if n < 0:
        return None
    return out_row[:n], out_col[:n], out_sk[:n].copy(), row_counts


PREF_BITS = 20  # top bits of the u64 hash forming the bucket id


def _prefix16(sorted_hashes: np.ndarray) -> np.ndarray:
    """Bucket index for a sorted uint64 array: entry p = lower_bound of
    p << (64-PREF_BITS) (length 2^PREF_BITS+1, int32). 20 bits puts the
    arg-annot anchor table at ~1.6 entries/bucket, so the in-bucket binary
    search all but disappears (the probes were cache misses)."""
    n_buckets = 1 << PREF_BITS
    bounds = np.arange(n_buckets, dtype=np.uint64) << np.uint64(64 - PREF_BITS)
    pref = np.empty(n_buckets + 1, np.int32)
    pref[:n_buckets] = np.searchsorted(sorted_hashes, bounds, side="left")
    pref[n_buckets] = len(sorted_hashes)
    return pref


def find_matches(aligner, codes, lengths, c_read, c_g):
    """Native hash-join candidate search (gio_find_matches); returns
    (m_b, m_var, m_row, m_pos, m_key, phf, phr) with matches sorted by
    (read, graph), or None. Only FULL-variant matches are emitted; the
    cascade probes clip variants lazily using the returned per-read prefix
    hashes (phf/phr, [B, L+2] uint64)."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_find_matches"):
        return None
    a = aligner
    if getattr(a, "_anchor_pref", None) is None or len(a._anchor_pref) != (1 << PREF_BITS) + 1:
        a._anchor_pref = _prefix16(a.anchor_hash)
        a._mini_pref = _prefix16(a.mini_hash)
    codes = np.ascontiguousarray(codes, np.uint8)
    B, L = codes.shape
    # per-thread reusable prefix-hash buffers: rows are only written/read
    # for combo reads, and the consumer (the cascade) finishes inside the
    # same process_batch call on the same worker thread
    import threading

    tls = getattr(find_matches, "_tls", None)
    if tls is None:
        tls = find_matches._tls = threading.local()
    # compact prefix-hash rows: one row per ACTIVE (combo) read, looked up
    # through ph_row[read]. Sizing by batch ([B, L+2] = 160MB at batch 64k)
    # cost ~850ms of THP zero-fill page faults on the first batch of every
    # worker thread — a third of a metagenome-mix pass.
    if len(c_read):
        first = np.empty(len(c_read), bool)
        first[0] = True
        np.not_equal(c_read[1:], c_read[:-1], out=first[1:])
        active = c_read[first]
    else:
        active = np.asarray(c_read, np.int64)
    n_act = max(len(active), 1)
    buf = getattr(tls, "buf", None)
    if buf is None or buf[0].shape[0] < n_act or buf[0].shape[1] != L + 2:
        rows_cap = max(1 << (n_act - 1).bit_length(), 1024)
        buf = (
            np.empty((rows_cap, L + 2), np.uint64),
            np.empty((rows_cap, L + 2), np.uint64),
        )
        tls.buf = buf
    phf, phr = buf
    ph_row = np.zeros(B, np.int32)
    ph_row[active] = np.arange(len(active), dtype=np.int32)
    cap = max(len(c_read) * 64, 1 << 20)
    for _attempt in range(4):
        m_b = np.empty(cap, np.int64)
        m_var = np.empty(cap, np.int8)
        m_row = np.empty(cap, np.int32)
        m_pos = np.empty(cap, np.int32)
        m_key = np.empty(cap, np.int64)
        n = lib.gio_find_matches(
            codes, B, L,
            np.ascontiguousarray(lengths, np.int64), a.k,
            len(c_read),
            np.ascontiguousarray(c_read, np.int64),
            np.ascontiguousarray(c_g, np.int64),
            ph_row, phf, phr,
            a.rpow, a.rinv, a.ph,
            np.ascontiguousarray(a.ph_start, np.int64),
            np.ascontiguousarray(a.path_len, np.int32),
            np.ascontiguousarray(a.flat_start, np.int64),
            a.flat_codes,
            np.ascontiguousarray(a.tfree, np.uint8),
            np.ascontiguousarray(a.nrow, np.uint8),
            np.ascontiguousarray(a.path_graph, np.int32),
            len(a.anchor_hash), a.anchor_hash,
            np.ascontiguousarray(a.anchor_row, np.int32),
            np.ascontiguousarray(a.anchor_pos, np.int32),
            len(a.mini_hash), a.mini_hash,
            np.ascontiguousarray(a.mini_row, np.int32),
            np.ascontiguousarray(a.mini_pos, np.int32),
            np.ascontiguousarray(a.mini_typ, np.int8),
            a._anchor_pref, a._mini_pref,
            a.len_mix, a.g_mix,
            len(a.npos_gi),
            np.ascontiguousarray(a.npos_gi, np.int64),
            np.ascontiguousarray(a.npos_row, np.int32),
            np.ascontiguousarray(a.npos_pos, np.int32),
            a.G,
            m_b, m_var, m_row, m_pos, m_key, cap,
        )
        if n == -2:
            return None  # pathological per-read match count: numpy path
        if n >= 0:
            return (
                m_b[:n], m_var[:n], m_row[:n], m_pos[:n], m_key[:n],
                phf, phr, ph_row,
            )
        cap *= 4
    return None


def verify(cand_b, cand_v, cand_row, cand_pos, codes, rc, lengths,
           path_len, flat_start, flat_codes, tfree):
    """Native wildcard byte verification; None if unavailable. rc may be
    None: reverse-complement bases are then derived in C from codes."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_verify"):
        return None
    n = len(cand_b)
    out = np.empty(n, np.uint8)
    codes = np.ascontiguousarray(codes, np.uint8)
    has_rc = rc is not None
    rc = codes if rc is None else np.ascontiguousarray(rc, np.uint8)
    lib.gio_verify(
        n,
        np.ascontiguousarray(cand_b, np.int64),
        np.ascontiguousarray(cand_v, np.int8),
        np.ascontiguousarray(cand_row, np.int64),
        np.ascontiguousarray(cand_pos, np.int64),
        codes, rc, int(has_rc), codes.shape[1],
        np.ascontiguousarray(lengths, np.int64),
        np.ascontiguousarray(path_len, np.int32),
        np.ascontiguousarray(flat_start, np.int64),
        np.ascontiguousarray(flat_codes, np.uint8),
        np.ascontiguousarray(tfree, np.uint8),
        out,
    )
    return out.astype(bool)


def bam_fill(off, hdr, name_off, name_len, name_buf, cig, ncig,
             nib_off, nib_len, nib_buf, qual_off, qual_len, qual_buf,
             total: int):
    """Native BAM record buffer assembly; None if unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_bam_fill"):
        return None
    out = np.empty(total, np.uint8)
    lib.gio_bam_fill(
        len(off),
        np.ascontiguousarray(off, np.int64),
        np.ascontiguousarray(hdr, np.uint32),
        np.ascontiguousarray(name_off, np.int64),
        np.ascontiguousarray(name_len, np.int64),
        np.ascontiguousarray(name_buf, np.uint8),
        np.ascontiguousarray(cig, np.uint32),
        np.ascontiguousarray(ncig, np.uint8),
        np.ascontiguousarray(nib_off, np.int64),
        np.ascontiguousarray(nib_len, np.int64),
        np.ascontiguousarray(nib_buf, np.uint8),
        np.ascontiguousarray(qual_off, np.int64),
        np.ascontiguousarray(qual_len, np.int64),
        np.ascontiguousarray(qual_buf, np.uint8),
        out,
    )
    return out


def lsh_query_full(hi, lo, kc, d, threshold, fsig, fpref, forder, sketches):
    """Native full-equality LSH query; returns (rows, wins) or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_lsh_query_full32"):
        return None
    B, s = hi.shape
    cap = max(B * 8, 4096)
    for _ in range(4):
        rows = np.empty(cap, np.int64)
        wins = np.empty(cap, np.int64)
        n = lib.gio_lsh_query_full32(
            np.ascontiguousarray(hi, np.uint32),
            np.ascontiguousarray(lo, np.uint32),
            B, s,
            np.ascontiguousarray(kc, np.float64), float(d), float(threshold),
            fsig, fpref, forder,
            np.ascontiguousarray(sketches, np.uint64),
            rows, wins, cap,
        )
        if n >= 0:
            return rows[:n], wins[:n]
        cap *= 8
    return None


def lsh_query_full64(
    q64, kc, d, threshold, fsig, fpref, forder, sketches, prescreened
):
    """Native full-equality LSH query on u64 sketches (no hi/lo split);
    returns (rows, wins) or None. `prescreened` marks batches sketched
    with the slot-0 prescreen, whose sentinel rows can skip the lookup."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_lsh_query_full64"):
        return None
    B, s = q64.shape
    cap = max(B * 8, 4096)
    for _ in range(4):
        rows = np.empty(cap, np.int64)
        wins = np.empty(cap, np.int64)
        n = lib.gio_lsh_query_full64(
            np.ascontiguousarray(q64, np.uint64), B, s,
            np.ascontiguousarray(kc, np.float64), float(d), float(threshold),
            fsig, fpref, forder,
            np.ascontiguousarray(sketches, np.uint64),
            1 if prescreened else 0,
            rows, wins, cap,
        )
        if n >= 0:
            return rows[:n], wins[:n]
        cap *= 8
    return None


def weight_pairs(wins, kc, cn_ptr, cn_cnt, cn_grow, cn_share,
                 w_multi, w_gidx, node_w, graph_kt) -> bool:
    """Native increment_subpath weight replay; False when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_weight_pairs"):
        return False
    lib.gio_weight_pairs(
        len(wins),
        np.ascontiguousarray(wins, np.int64),
        np.ascontiguousarray(kc, np.float64),
        cn_ptr, cn_cnt, cn_grow, cn_share,
        w_multi, w_gidx, node_w, graph_kt,
    )
    return True


def gather_bytes(buf, src_off, src_len, dst_off, out) -> bool:
    """memcpy n byte ranges buf[src_off:+src_len] -> out[dst_off:]; False
    when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_gather_bytes"):
        return False
    lib.gio_gather_bytes(
        _buf_ptr(buf), len(src_off),
        np.ascontiguousarray(src_off, np.int64),
        np.ascontiguousarray(src_len, np.int64),
        np.ascontiguousarray(dst_off, np.int64),
        out,
    )
    return True


def emit_records(
    idc, ido, idl, sqc, sqo, sql, quc, quo, qul,
    rev, cs, ce, group_ptr, ref_ids, poss, cap: int,
):
    """Native whole-batch BAM record assembly (gio_emit_records); returns
    the record bytes as a uint8 array, or None when unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_emit_records"):
        return None
    out = np.empty(cap, np.uint8)
    n = lib.gio_emit_records(
        len(ido),
        np.ascontiguousarray(idc, np.uint8),
        np.ascontiguousarray(ido, np.int64),
        np.ascontiguousarray(idl, np.int64),
        np.ascontiguousarray(sqc, np.uint8),
        np.ascontiguousarray(sqo, np.int64),
        np.ascontiguousarray(sql, np.int64),
        np.ascontiguousarray(quc, np.uint8),
        np.ascontiguousarray(quo, np.int64),
        np.ascontiguousarray(qul, np.int64),
        np.ascontiguousarray(rev, np.uint8),
        np.ascontiguousarray(cs, np.int16),
        np.ascontiguousarray(ce, np.int16),
        np.ascontiguousarray(group_ptr, np.int64),
        np.ascontiguousarray(ref_ids, np.int32),
        np.ascontiguousarray(poss, np.int64),
        out, cap,
    )
    if n < 0:
        return None
    return out[:n]


def bam_scan(data: np.ndarray, start: int):
    """Scan decompressed BAM records -> (ref_id, pos, flag, aln_len) arrays,
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_bam_scan"):
        return None
    data = np.ascontiguousarray(data, np.uint8)
    cap = max((len(data) - start) // 40 + 16, 16)
    ref_id = np.empty(cap, np.int32)
    pos = np.empty(cap, np.int32)
    flag = np.empty(cap, np.uint16)
    aln_len = np.empty(cap, np.int32)
    n = lib.gio_bam_scan(data, len(data), start, ref_id, pos, flag, aln_len, cap)
    if n < 0:
        return None
    return ref_id[:n], pos[:n], flag[:n], aln_len[:n]


def bgzf_block(data: bytes) -> Optional[bytes]:
    """Native BGZF block compression, or None to use the Python path."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(data) + 1024, np.uint8)
    n = lib.gio_bgzf_block(data, len(data), out, len(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def inflate_blocks(raw, off, clen, isize, total: int) -> "Optional[np.ndarray]":
    """Inflate pre-walked BGZF blocks (raw deflate payloads) with
    libdeflate in one native call, or None to use the zlib path. ``raw``
    is the whole BGZF stream (any bytes-like object, mmap included);
    returns the decompressed bytes as a uint8 array (no copy-out)."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_inflate_blocks"):
        return None
    out = np.empty(total, np.uint8)
    n = lib.gio_inflate_blocks(
        _buf_ptr(raw), np.ascontiguousarray(off, np.int64),
        np.ascontiguousarray(clen, np.int64),
        np.ascontiguousarray(isize, np.int64), len(off), out,
    )
    if n != total:
        return None
    return out


def gunzip(data) -> "Optional[np.ndarray]":
    """Decompress a whole gzip byte buffer (single- or multi-member) with
    libdeflate in one native call; returns a uint8 array or None to use
    the zlib streaming path. Capacity is seeded from the final member's
    ISIZE footer (exact for the common single-member FASTQ case) and grown
    on demand for concatenated members."""
    lib = _load()
    n = len(data)
    if lib is None or not hasattr(lib, "gio_gunzip") or n < 18:
        return None
    isize = int.from_bytes(data[-4:], "little")
    # trust the ISIZE seed first: max(isize, n*2) over-allocates ~2x for
    # barely-compressible inputs, and out[:r] pins the whole buffer for
    # the caller's lifetime. Only on retry (multi-member concatenation,
    # ISIZE wrap) fall back to growing from n*2.
    cap = max(isize + 64, 1 << 16)
    for _ in range(8):
        out = np.empty(cap, np.uint8)
        r = lib.gio_gunzip(_buf_ptr(data), n, out, cap)
        if r == -2:
            cap = max(cap * 4, n * 2)
            continue
        if r < 0:
            return None
        if cap - r > max(r // 4, 1 << 20):
            out = out[:r].copy()  # don't pin a >1.25x over-allocation
            return out
        return out[:r]
    return None


def bgzf_many(data, bs: int = 0xFF00):
    """Compress a run of consecutive BGZF blocks in one native call (one
    GIL release per batch), or None to use the per-block path. ``data`` is
    any bytes-like object; returns a uint8 array view of the compressed
    bytes (callers hand it straight to a buffer-protocol write)."""
    lib = _load()
    if lib is None or not hasattr(lib, "gio_bgzf_many"):
        return None
    nblocks = max(-(-len(data) // bs), 1)
    out = np.empty(len(data) + 1024 * (nblocks + 1), np.uint8)
    n = lib.gio_bgzf_many(_buf_ptr(data), len(data), bs, out, len(out))
    if n < 0:
        return None
    return out[:n]


def dev_reduce(packed, r_pair, j1, s3, s4) -> bool:
    """Phase-A drain reduction for the device engine (gio_dev_reduce):
    per-pair stage-1 min offsets + clip-flag ORs, in place."""
    lib = _load()
    if lib is None:
        return False
    lib.gio_dev_reduce(
        np.ascontiguousarray(packed, np.int32),
        np.ascontiguousarray(r_pair, np.int64),
        len(packed),
        j1, s3.view(np.uint8), s4.view(np.uint8),
    )
    return True


def dev_ids(packed, r_pair, r_prow, r_base, is_winner, ori, stage,
            j1pick, combo_of_pair):
    """Winner-id recovery for one seed_scan call (gio_dev_ids). Returns
    (combo, row, pos) arrays or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n = len(packed)
    out_c = np.empty(n, np.int64)
    out_r = np.empty(n, np.int64)
    out_p = np.empty(n, np.int64)
    m = lib.gio_dev_ids(
        np.ascontiguousarray(packed, np.int32),
        np.ascontiguousarray(r_pair, np.int64),
        np.ascontiguousarray(r_prow, np.int32),
        np.ascontiguousarray(r_base, np.int32),
        n,
        is_winner.view(np.uint8),
        np.ascontiguousarray(ori, np.uint8),
        np.ascontiguousarray(stage, np.uint8),
        np.ascontiguousarray(j1pick, np.int64),
        np.ascontiguousarray(combo_of_pair, np.int64),
        out_c, out_r, out_p,
    )
    return out_c[:m], out_r[:m], out_p[:m]


def s2_decide(sel_pair, sel_win, cand_ptr, cand_row, cand_pos,
              cn_ptr, cn_cnt, cn_grow, node_base, node_g, g_first_row,
              npos_dense, node_len, ns):
    """Inline stage-2 (rank x shuffle) decision (gio_s2_decide). Returns
    (best_key_per_sel, id_pair, id_row, id_pos, id_key) or None."""
    lib = _load()
    if lib is None:
        return None
    n_sel = len(sel_pair)
    best = np.empty(n_sel, np.int64)
    cap = len(cand_row) if len(cand_row) else 1
    id_pair = np.empty(cap, np.int64)
    id_row = np.empty(cap, np.int64)
    id_pos = np.empty(cap, np.int64)
    id_key = np.empty(cap, np.int64)
    m = lib.gio_s2_decide(
        n_sel,
        np.ascontiguousarray(sel_pair, np.int64),
        np.ascontiguousarray(sel_win, np.int64),
        np.ascontiguousarray(cand_ptr, np.int64),
        np.ascontiguousarray(cand_row, np.int64),
        np.ascontiguousarray(cand_pos, np.int64),
        np.ascontiguousarray(cn_ptr, np.int64),
        np.ascontiguousarray(cn_cnt, np.int32),
        np.ascontiguousarray(cn_grow, np.int64),
        np.ascontiguousarray(node_base, np.int64),
        np.ascontiguousarray(node_g, np.int32),
        np.ascontiguousarray(g_first_row, np.int64),
        np.ascontiguousarray(npos_dense, np.int32),
        len(npos_dense),
        np.ascontiguousarray(node_len, np.int32),
        ns,
        best,
        id_pair, id_row, id_pos, id_key,
    )
    return best, id_pair[:m], id_row[:m], id_pos[:m], id_key[:m]


def s2_enum(va, vfull, crl, anchor_hash, anchor_row, anchor_pos, apref,
            path_len, ph_start, ph, rinv):
    """Interior stage-2 candidate enumeration (gio_s2_enum). Returns
    (owner, row, pos) arrays or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n = len(va)
    cap = max(32 * n, 4096)
    a_row = np.ascontiguousarray(anchor_row, np.int32)
    a_pos = np.ascontiguousarray(anchor_pos, np.int32)
    pl = np.ascontiguousarray(path_len, np.int32)
    while True:
        out_o = np.empty(cap, np.int64)
        out_r = np.empty(cap, np.int64)
        out_p = np.empty(cap, np.int64)
        m = lib.gio_s2_enum(
            n,
            np.ascontiguousarray(va, np.uint64),
            np.ascontiguousarray(vfull, np.uint64),
            np.ascontiguousarray(crl, np.int64),
            len(anchor_hash), anchor_hash, a_row, a_pos,
            np.ascontiguousarray(apref, np.int32), 64 - PREF_BITS,
            pl, np.ascontiguousarray(ph_start, np.int64),
            ph, np.ascontiguousarray(rinv, np.uint64),
            out_o, out_r, out_p, cap,
        )
        if m >= 0:
            return out_o[:m], out_r[:m], out_p[:m]
        cap *= 4
