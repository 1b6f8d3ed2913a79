"""Hash-join exact aligner (aligner v5).

Reference semantics: GrootGraph.AlignRead's hierarchical cascade
(/root/reference/src/graph/alignment.go:34-103) probes exact matches of a
read variant (fwd/RC x full/clip-start/clip-end, MaxClip=1) against graph
paths at seed-derived positions; graphminion.go:46-102 tries a read's
mappings in order and keeps the first success per graph.

The previous engine (align.aligner) brute-forces a match volume over
EVERY (path, position) with a cross-correlation — ~3000x
more positions than the cascade's probe set ever reads. v5 inverts the
lookup: exact matching is substring search, so candidate positions come from
an O(log N) hash join instead of an O(N*Lr) scan:

  * setup: flat path sequences + polynomial prefix hashes (mod 2^64); ONE
    sorted anchor table of the k-length substring hash at every path
    position (k = index k-mer size, <= every sketchable read length); a
    small suffix mini-table for <k-base overhangs at terminal-free path
    ends (dead-end partial DFS matches, alignment.go:229).
  * per batch: hash the 4 distinct variant anchors per read (clip-end
    shares the fwd/RC prefix), searchsorted into the anchor table, O(1)
    full-length hash verification per candidate (interior or overhang), then
    the staged winner logic runs as vectorized numpy over (pair, match)
    joins — the probe positions of stages 1-4 are pure position arithmetic
    against the match list.
  * winning matches are byte-verified against the real path codes before a
    BAM record is emitted, so a 2^-64 hash collision can only cost a
    (logged) per-combo fallback to the legacy aligner, never a wrong record.

Graphs whose paths contain N (wildcard: matches ANY read base, which
equality hashing cannot express) and reads with len <= k are routed to the
legacy GraphAligner (host, bit-volume based) per graph.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

import numpy as np

from ..graph.grootgraph import GrootGraph
from ..ops.nthash import ASCII_TO_CODE, CODE_TO_ASCII, RC_CODE_NP
from .aligner import AlignmentRecord, GraphAligner, NODE_SHUFFLES, _GraphPack
from .batch_host import winners

log = logging.getLogger("groot")

RBASE = np.uint64(0x9E3779B97F4A7C15)  # odd -> invertible mod 2^64
_RINV_INT = pow(0x9E3779B97F4A7C15, -1, 1 << 64)
BIG = np.int64(2**62)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _index_fingerprint(index, k: int) -> np.ndarray:
    """Consistency fingerprint binding a groot.align sidecar to the
    groot.lshe index it was derived from: CRC of the sketch matrix plus
    its shape and the anchor k. A rebuilt index (or one copied next to a
    stale sidecar) fingerprints differently and forces a fresh setup."""
    import zlib

    sk = np.ascontiguousarray(index.sketches)
    crc = zlib.crc32(sk.tobytes())
    s = sk.shape[1] if sk.ndim > 1 else 0
    return np.array([crc, len(sk), s, k], dtype=np.int64)


class NumpyGraphAligner(GraphAligner):
    """GraphAligner with the match volumes computed in numpy instead of an
    XLA conv — the fallback engine for wildcard graphs must not trigger
    device compiles (each distinct conv shape is a fresh XLA compile; the
    fallback set is tiny so numpy is instant)."""

    def _batch_match_bits(self, gp: _GraphPack, reads):
        R = len(reads)
        Lr_b = -(-max(max(len(r.seq) for r in reads), 32) // 32) * 32
        codes = gp.packed.codes
        P, L = codes.shape
        padded = np.full((P, L + Lr_b), 4, dtype=np.uint8)
        padded[:, :L] = codes
        win = np.lib.stride_tricks.sliding_window_view(
            padded, Lr_b, axis=1
        )  # [P, W, Lr_b] view
        W = win.shape[1]
        W32 = -(-W // 32)
        bits = np.zeros((R, 6, P, W32), dtype=np.uint32)
        shift32 = np.arange(32, dtype=np.uint32)
        for r, read in enumerate(reads):
            rcodes = ASCII_TO_CODE[np.frombuffer(read.seq, dtype=np.uint8)]
            rc = RC_CODE_NP[rcodes][::-1]
            Lr = len(rcodes)
            for o, cs in enumerate((rcodes, rc)):
                variants = (
                    (cs, 0),          # full
                    (cs[1:], 1),      # clip-start
                    (cs[: Lr - 1], 2),  # clip-end
                )
                for vc, vi in variants:
                    eff = len(vc)
                    w = win[:, :, :eff]
                    m = ((w == vc[None, None, :]) | (w == 4)).all(axis=2)
                    mp = np.zeros((P, W32 * 32), dtype=bool)
                    mp[:, :W] = m
                    bits[r, o * 3 + vi] = (
                        mp.reshape(P, W32, 32).astype(np.uint32) << shift32
                    ).sum(axis=2, dtype=np.uint32)
        return bits


class HashAligner:
    """Exact cascade alignment by hash join over the flat pair lists
    (align.batch_host). Synchronous host numpy."""

    def __init__(self, store: Dict[int, GrootGraph], references=None):
        self.store = store
        self.references = references
        self.legacy = NumpyGraphAligner(store, references)
        self._packs: Dict[int, _GraphPack] = {}
        # RC translation: complement ACGT (any case), everything else -> N
        # (matches CODE_TO_ASCII[RC_CODE_NP[ASCII_TO_CODE[...]]])
        tab = bytearray(b"N" * 256)
        for src, dst in zip(b"ACGTacgt", b"TGCATGCA"):
            tab[src] = dst
        self._rc_trans = bytes(tab)
        self._rc_lut = np.frombuffer(self._rc_trans, np.uint8)

    # array attributes persisted in the groot.align sidecar
    _ARRAYS = (
        "path_graph", "path_pid", "path_len", "tfree", "flat_start",
        "flat_codes", "rpow", "rinv", "ph", "ph_start", "nrow",
        "npos_gi", "npos_row", "npos_pos",
        "anchor_hash", "anchor_row", "anchor_pos",
        "len_mix", "g_mix", "mini_hash", "mini_row", "mini_pos", "mini_typ",
        "node_len", "node_g", "g_first_row", "node_base", "npos_dense",
        "ref_id_by_prow",
    )

    _WT_ARRAYS = (
        "node_table", "graph_ids", "w_graph", "w_node", "w_off", "w_span",
        "w_multi", "w_seed_grow", "cn_ptr", "cn_grow", "cn_share", "cn_cnt",
    )

    _SIDE_MAGIC = b"GROOTALN2\x00"

    def save_arrays(self, path: str) -> None:
        """Persist the setup arrays (pure functions of the index + k) plus
        the WindowTables arrays, so align skips the per-graph
        packing/hashing entirely (the groot.align sidecar). Format: magic +
        pickled {name: (dtype, shape, offset)} header + 64-byte-aligned raw
        array blobs — loads as ONE sequential read + np.frombuffer views
        (np.savez went through zipfile + crc32 at ~100MB/s on load)."""
        import pickle
        import struct as _struct

        payload = {name: getattr(self, name) for name in self._ARRAYS}
        for name in self._WT_ARRAYS:
            payload["wt_" + name] = getattr(self.tables, name)
        payload["_scalars"] = np.array(
            [self.R, self.G, self.k, self._pos_bits], dtype=np.int64
        )
        payload["_fingerprint"] = self._fingerprint
        payload = {
            k_: np.ascontiguousarray(v) for k_, v in payload.items()
        }
        meta = {}
        off = 0
        for name, arr in payload.items():
            off = (off + 63) & ~63
            meta[name] = (arr.dtype.str, arr.shape, off)
            off += arr.nbytes
        hdr = pickle.dumps(meta, protocol=4)
        # pad the header so the blob base (magic + 8 + hlen) lands on a
        # 64-byte boundary — offsets are 64-aligned relative to base, so
        # this keeps the mmap'ed views truly 64-byte aligned in memory
        # (pickle ignores bytes after the STOP opcode)
        pre = len(self._SIDE_MAGIC) + 8
        hdr += b"\x00" * (-(pre + len(hdr)) % 64)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(self._SIDE_MAGIC)
            fh.write(_struct.pack("<q", len(hdr)))
            fh.write(hdr)
            base = fh.tell()
            for name, arr in payload.items():
                pos = base + meta[name][2]
                fh.seek(pos)
                fh.write(arr.tobytes())
        os.replace(tmp, path)

    def try_load(self, index, path: str, k: int):
        """Load the groot.align sidecar; returns the reconstructed
        WindowTables, or None when absent/stale. Staleness is detected by
        the index fingerprint stored in the sidecar (a sidecar written for
        a different/rebuilt groot.lshe, or a different k, is rejected)."""
        import pickle
        import struct as _struct

        from .batch_host import WindowTables

        import mmap as _mmap

        try:
            with open(path, "rb") as fh:
                magic = fh.read(len(self._SIDE_MAGIC))
                if magic != self._SIDE_MAGIC:
                    return None  # old/foreign format -> rebuild
                (hlen,) = _struct.unpack("<q", fh.read(8))
                meta = pickle.loads(fh.read(hlen))
                base = fh.tell()
                # mmap instead of read(): the ~100MB of setup arrays become
                # zero-copy page-cache views (a bulk read() copy cost ~0.2s
                # per align run); arrays are 64-byte aligned in the file
                try:
                    blob = _mmap.mmap(
                        fh.fileno(), 0, access=_mmap.ACCESS_READ
                    )
                    if hasattr(blob, "madvise"):
                        blob.madvise(_mmap.MADV_WILLNEED)
                except (ValueError, OSError):
                    fh.seek(base)
                    blob = fh.read()
                    base = 0
        except (OSError, ValueError, EOFError, pickle.UnpicklingError):
            return None
        def discard():
            if isinstance(blob, _mmap.mmap):
                blob.close()
            return None

        need = set(self._ARRAYS) | {"wt_" + n for n in self._WT_ARRAYS}
        if (need - set(meta)) or "_fingerprint" not in meta:
            return discard()

        def get(name):
            dt, shape, off = meta[name]
            n = int(np.prod(shape)) if shape else 1
            a = np.frombuffer(
                blob, dtype=np.dtype(dt), count=n, offset=base + off
            )
            return a.reshape(shape)

        expect = _index_fingerprint(index, int(k))
        if not np.array_equal(get("_fingerprint"), expect):
            log.warning(
                "groot.align sidecar does not match the loaded index; "
                "rebuilding alignment tables"
            )
            return discard()  # don't retain a stale mapping
        self._side_mmap = blob  # keep the mapping alive with the views
        self._fingerprint = expect
        data = {name: get(name) for name in need}
        for name in self._ARRAYS:
            setattr(self, name, data[name])
        self.R, self.G, self.k, self._pos_bits = (
            int(x) for x in get("_scalars")
        )
        self._finish_setup()
        tables = WindowTables.__new__(WindowTables)
        for name in self._WT_ARRAYS:
            setattr(tables, name, data["wt_" + name])
        tables.num_windows = len(tables.w_graph)
        tables.num_nodes = len(tables.node_table)
        self.tables = tables
        self.keys = index.keys
        return tables

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def attach_tables(self, tables, index, k: int) -> None:
        """Build the global path/hash/anchor arrays. `tables` is the flat
        WindowTables (its node rows define the grow numbering); `index` is
        the ContainmentIndex (Key objects for the legacy fallback); `k` is
        the index k-mer size (every sketchable read has len >= k)."""
        self.tables = tables
        self.keys = index.keys
        self.k = int(k)
        self._fingerprint = _index_fingerprint(index, self.k)
        store = self.store
        t = tables
        gids = t.graph_ids  # sorted
        G = len(gids)

        # ---- path rows ------------------------------------------------
        prow_of: Dict[Tuple[int, int], int] = {}
        path_graph: List[int] = []   # gidx per row
        path_pid: List[int] = []
        path_len: List[int] = []
        tfree: List[bool] = []
        row_codes: List[np.ndarray] = []
        for gi, gid in enumerate(gids.tolist()):
            graph = store[gid]
            gp = self._pack(graph)
            for r, pid in enumerate(gp.path_ids):
                prow_of[(gi, pid)] = len(path_graph)
                path_graph.append(gi)
                path_pid.append(pid)
                plen = int(gp.lengths[r])
                path_len.append(plen)
                tfree.append(bool(gp.terminal_free[pid]))
                row_codes.append(gp.packed.codes[r, :plen])
        R = len(path_graph)
        self.R = R
        self.G = G
        self.path_graph = np.array(path_graph, dtype=np.int32)
        self.path_pid = np.array(path_pid, dtype=np.int64)
        self.path_len = np.array(path_len, dtype=np.int32)
        self.tfree = np.array(tfree, dtype=bool)

        # ---- flat codes + prefix hashes --------------------------------
        lens = self.path_len.astype(np.int64)
        self.flat_start = np.concatenate(([0], np.cumsum(lens[:-1])))
        self.flat_codes = (
            np.concatenate(row_codes) if R else np.empty(0, np.uint8)
        )
        Lmax = int(lens.max()) if R else 1
        npow = max(Lmax, 8192) + 2  # cover any read length too
        with np.errstate(over="ignore"):
            rpow = np.empty(npow, dtype=np.uint64)
            rinv = np.empty(npow, dtype=np.uint64)
            rpow[0] = rinv[0] = 1
            rb = np.uint64(RBASE)
            ri = np.uint64(_RINV_INT)
            for i in range(1, npow):
                rpow[i] = rpow[i - 1] * rb
                rinv[i] = rinv[i - 1] * ri
        self.rpow = rpow
        self.rinv = rinv
        self._pos_bits = (Lmax + 2).bit_length()

        ph = np.zeros(len(self.flat_codes) + R, dtype=np.uint64)
        self.ph_start = self.flat_start + np.arange(R, dtype=np.int64)
        with np.errstate(over="ignore"):
            for r in range(R):
                plen = int(lens[r])
                poff = int(self.ph_start[r])
                vals = (
                    row_codes[r].astype(np.uint64) + np.uint64(1)
                ) * rpow[:plen]
                ph[poff + 1 : poff + 1 + plen] = np.cumsum(vals)
        self.ph = ph

        # N (code 4) in a path is a wildcard the equality hash cannot
        # express. Paths index with N as a LITERAL symbol; wildcard-crossing
        # matches are recovered by (a) the N-segment entries of the mini
        # table below (N within the first k bases of a match), (b) a
        # wildcard byte-verify for anchor candidates on N-rows (N after the
        # anchor), and (c) per-combo q=0 probes at the N itself.
        self.nrow = np.array(
            [bool((c == 4).any()) for c in row_codes], dtype=bool
        )
        # N positions per graph: flat (gidx-sorted) CSR for the q=0 probes
        g_np_row: List[int] = []
        g_np_pos: List[int] = []
        g_np_gi: List[int] = []
        for r in np.flatnonzero(self.nrow).tolist():
            for npos_ in np.flatnonzero(
                row_codes[r] == 4
            ).tolist():
                g_np_gi.append(int(self.path_graph[r]))
                g_np_row.append(r)
                g_np_pos.append(npos_)
        self.npos_gi = np.array(g_np_gi, dtype=np.int64)
        self.npos_row = np.array(g_np_row, dtype=np.int32)
        self.npos_pos = np.array(g_np_pos, dtype=np.int32)
        o = np.argsort(self.npos_gi, kind="stable")
        self.npos_gi, self.npos_row, self.npos_pos = (
            self.npos_gi[o], self.npos_row[o], self.npos_pos[o],
        )

        # ---- anchor table (k-length substring hash of every position) --
        ah_parts: List[np.ndarray] = []
        ar_parts: List[np.ndarray] = []
        ap_parts: List[np.ndarray] = []
        with np.errstate(over="ignore"):
            for r in range(R):
                plen = int(lens[r])
                n = plen - self.k + 1
                if n <= 0:
                    continue
                s = self.ph_start[r]
                pos = np.arange(n, dtype=np.int64)
                h = (ph[s + pos + self.k] - ph[s + pos]) * rinv[pos]
                ah_parts.append(h)
                ar_parts.append(np.full(n, r, dtype=np.int32))
                ap_parts.append(pos.astype(np.int32))
        ah = np.concatenate(ah_parts) if ah_parts else np.empty(0, np.uint64)
        arow = np.concatenate(ar_parts) if ar_parts else np.empty(0, np.int32)
        apos = np.concatenate(ap_parts) if ap_parts else np.empty(0, np.int32)
        order = np.argsort(ah, kind="stable")
        self.anchor_hash = ah[order]
        self.anchor_row = arow[order]
        self.anchor_pos = apos[order]

        # ---- mini table: graph-gated prefix join for q in 1..k-1 --------
        # Entries keyed by hash(path[pos:pos+q]) ^ MIX[q] ^ GMIX[gidx]; the
        # graph mix makes the join combo-local — without it every read's
        # 1..3-base prefixes match thousands of unrelated tails (measured:
        # 12M junk matches/batch). Two entry types:
        #   OVER (pos = plen-q, terminal-free): complete <k-base overhang
        #     match of the read prefix hanging off the path end
        #     (alignment.go:229 dead ends);
        #   NSEG (pos = npos-q): the N-free literal segment before a path
        #     N; a candidate whose tail must be wildcard byte-verified.
        self.len_mix = np.array(
            [_splitmix64(q ^ 0x517CC1B727220A95) for q in range(self.k + 1)],
            dtype=np.uint64,
        )
        self.g_mix = np.array(
            [_splitmix64(g ^ 0x2545F4914F6CDD1D) for g in range(G)],
            dtype=np.uint64,
        )
        mk_parts, mrow_parts, mpos_parts, mtyp_parts = [], [], [], []
        with np.errstate(over="ignore"):
            for r in range(R):
                plen = int(lens[r])
                s = self.ph_start[r]
                gmix = self.g_mix[self.path_graph[r]]
                if self.tfree[r]:
                    w0 = max(0, plen - (self.k - 1))
                    if w0 < plen:
                        w = np.arange(w0, plen, dtype=np.int64)
                        q = plen - w
                        h = (ph[s + plen] - ph[s + w]) * rinv[w]
                        mk_parts.append(h ^ self.len_mix[q] ^ gmix)
                        mrow_parts.append(np.full(len(w), r, np.int32))
                        mpos_parts.append(w.astype(np.int32))
                        mtyp_parts.append(np.zeros(len(w), np.int8))  # OVER
                if self.nrow[r]:
                    for npos_ in np.flatnonzero(row_codes[r] == 4).tolist():
                        q = np.arange(
                            1, min(self.k - 1, npos_) + 1, dtype=np.int64
                        )
                        if not len(q):
                            continue
                        w = npos_ - q
                        h = (ph[s + npos_] - ph[s + w]) * rinv[w]
                        mk_parts.append(h ^ self.len_mix[q] ^ gmix)
                        mrow_parts.append(np.full(len(q), r, np.int32))
                        mpos_parts.append(w.astype(np.int32))
                        mtyp_parts.append(np.ones(len(q), np.int8))  # NSEG
        mk = np.concatenate(mk_parts) if mk_parts else np.empty(0, np.uint64)
        mrow = (
            np.concatenate(mrow_parts) if mrow_parts else np.empty(0, np.int32)
        )
        mpos = (
            np.concatenate(mpos_parts) if mpos_parts else np.empty(0, np.int32)
        )
        mtyp = (
            np.concatenate(mtyp_parts) if mtyp_parts else np.empty(0, np.int8)
        )
        order = np.argsort(mk, kind="stable")
        self.mini_hash = mk[order]
        self.mini_row = mrow[order]
        self.mini_pos = mpos[order]
        self.mini_typ = mtyp[order]

        # ---- node -> (path row, start) lookup ---------------------------
        # dense per-graph rows: node `grow` of graph g stores start
        # positions for ALL of g's path rows at
        # npos_dense[node_base[grow] + (prow - g_first_row[g])] (-1 = node
        # not on that path). O(1) gathers — the lookup runs once per
        # (pair, match) and per stage-2 probe, the hottest joins.
        g_first_row = np.zeros(G + 1, dtype=np.int64)
        for r in range(R):
            g_first_row[self.path_graph[r] + 1] = r + 1
        self.g_first_row = g_first_row
        g_npaths = np.diff(g_first_row)

        node_len = np.zeros(t.num_nodes, dtype=np.int32)
        node_g = np.zeros(t.num_nodes, dtype=np.int32)
        grow = 0
        for gi, gid in enumerate(gids.tolist()):
            for node in store[gid].sorted_nodes:
                node_len[grow] = len(node.sequence)
                node_g[grow] = gi
                grow += 1
        assert grow == t.num_nodes
        self.node_len = node_len
        self.node_g = node_g
        node_base = np.zeros(t.num_nodes + 1, dtype=np.int64)
        np.cumsum(g_npaths[node_g], out=node_base[1:])
        self.node_base = node_base[:-1]
        npos_dense = np.full(int(node_base[-1]), -1, dtype=np.int32)
        grow = 0
        for gi, gid in enumerate(gids.tolist()):
            base_row = g_first_row[gi]
            for node in store[gid].sorted_nodes:
                nb = self.node_base[grow]
                for pid, pos in node.position.items():
                    npos_dense[nb + (prow_of[(gi, pid)] - base_row)] = pos
                grow += 1
        self.npos_dense = npos_dense

        self._finish_setup()

        # global BAM ref id per path row (build_references numbering)
        if self.references is not None:
            self.ref_id_by_prow = np.array(
                [
                    self.references.by_path[
                        (int(gids[self.path_graph[r]]), int(self.path_pid[r]))
                    ].ref_id
                    for r in range(R)
                ],
                dtype=np.int32,
            )
        else:
            self.ref_id_by_prow = None

    def _finish_setup(self) -> None:
        """Shared-table epilogue for attach_tables/try_load: the 16-bit
        prefix bucket indexes (io.native) built eagerly, plus the locks the
        pooled batch workers need (align_pipeline._run_align_pooled)."""
        import threading

        from ..io.native import _prefix16

        self._anchor_pref = _prefix16(self.anchor_hash)
        self._mini_pref = _prefix16(self.mini_hash)
        self._max_paths = (
            int(np.diff(self.g_first_row).max()) if self.G else 1
        )
        self._pow_lock = threading.Lock()
        self._fb_lock = threading.Lock()

    def _ensure_pow(self, n: int) -> None:
        """Grow rpow/rinv to cover indices < n. The setup sizes them for
        max(path Lmax, 8192)+2, but both tables are also indexed by READ
        length (PHf/PHr prefixes, native gio_find_matches) — a long-read
        batch beyond that would read out of bounds."""
        if n <= len(self.rpow):
            return
        with self._pow_lock:
            old = len(self.rpow)
            if n <= old:
                return
            rpow = np.empty(n, dtype=np.uint64)
            rinv = np.empty(n, dtype=np.uint64)
            rpow[:old] = self.rpow
            rinv[:old] = self.rinv
            with np.errstate(over="ignore"):
                rb = np.uint64(RBASE)
                ri = np.uint64(_RINV_INT)
                for i in range(old, n):
                    rpow[i] = rpow[i - 1] * rb
                    rinv[i] = rinv[i - 1] * ri
            self.rpow = rpow
            self.rinv = rinv

    def _pack(self, graph: GrootGraph) -> _GraphPack:
        gp = self._packs.get(graph.graph_id)
        if gp is None:
            gp = _GraphPack(graph)
            self._packs[graph.graph_id] = gp
        return gp

    # ------------------------------------------------------------------
    # per-batch
    # ------------------------------------------------------------------
    def _npos_lookup(self, grow: np.ndarray, mrow: np.ndarray):
        """(found, start) of node `grow` in path row `mrow`: O(1) gathers
        into the dense per-graph position rows. `mrow` must belong to the
        node's graph (guaranteed by the (read, graph) combo joins)."""
        if len(grow) == 0:
            return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int64)
        idx = self.node_base[grow] + (
            mrow - self.g_first_row[self.node_g[grow]]
        )
        v = self.npos_dense[idx]
        return v >= 0, v.astype(np.int64)

    def _verify_candidates(self, cand_b, cand_v, cand_row, cand_pos, codes, rc, lengths):
        """Wildcard-aware byte verification of candidate matches, vectorized:
        candidate (b, v, row, pos) matches iff every variant base equals the
        path base or the path base is N, with overhang past the path end only
        at terminal-free rows (_probe semantics, aligner.py:247-269)."""
        n = len(cand_b)
        if n == 0:
            return np.zeros(0, dtype=bool)
        if not os.environ.get("GROOT_NO_NATIVE_CASCADE"):
            from ..io import native

            out = native.verify(
                cand_b, cand_v, cand_row, cand_pos, codes, rc, lengths,
                self.path_len, self.flat_start, self.flat_codes,
                self.tfree.astype(np.uint8),
            )
            if out is not None:
                return out
        if rc is None:
            L = codes.shape[1]
            rev_idx = np.clip(
                lengths[:, None] - 1 - np.arange(L)[None, :], 0, L - 1
            )
            rc = RC_CODE_NP[np.take_along_axis(codes, rev_idx, 1)]
        L = codes.shape[1]
        eff = lengths[cand_b] - (cand_v % 3 != 0)
        cs = (cand_v % 3 == 1).astype(np.int64)
        src = np.where((cand_v >= 3)[:, None], rc[cand_b], codes[cand_b])
        I = np.arange(L, dtype=np.int64)[None, :]
        vbase = np.take_along_axis(
            src, np.minimum(cs[:, None] + I, L - 1), axis=1
        )
        plen = self.path_len[cand_row].astype(np.int64)
        pi = cand_pos[:, None].astype(np.int64) + I
        within = I < eff[:, None]
        in_path = pi < plen[:, None]
        fidx = np.minimum(
            self.flat_start[cand_row][:, None] + pi, len(self.flat_codes) - 1
        )
        pbase = self.flat_codes[fidx]
        okpos = ~within | ~in_path | (pbase == vbase) | (pbase == 4)
        over = within & ~in_path
        return okpos.all(axis=1) & (~over.any(axis=1) | self.tfree[cand_row])

    def _find_matches(self, codes, lengths, active, c_read, c_g):
        """All exact matches of every active read's 6 variants against every
        path: (m_b, m_var, m_row, m_pos) sorted by (read, graph); the mini
        join (<k overhangs, N-crossing segments) is gated to the (read,
        graph) combos given.
        var encoding: 0=f 1=f-clip-start 2=f-clip-end 3=rc 4=rc-cs 5=rc-ce."""
        B, L = codes.shape
        k = self.k
        GROUP_VARS = ((0, 2), (1,), (3, 5), (4,))
        m_b: List[np.ndarray] = []
        m_var: List[np.ndarray] = []
        m_row: List[np.ndarray] = []
        m_pos: List[np.ndarray] = []
        # suspect candidates routed through wildcard byte-verify
        s_b: List[np.ndarray] = []
        s_var: List[np.ndarray] = []
        s_row: List[np.ndarray] = []
        s_pos: List[np.ndarray] = []
        bidx = np.arange(B)

        with np.errstate(over="ignore"):
            rpow = self.rpow
            rinv1 = self.rinv[1]
            vals = (codes.astype(np.uint64) + np.uint64(1)) * rpow[:L]
            PHf = np.zeros((B, L + 1), dtype=np.uint64)
            np.cumsum(vals, axis=1, out=PHf[:, 1:])
            rev_idx = np.clip(
                lengths[:, None] - 1 - np.arange(L)[None, :], 0, L - 1
            )
            rc = RC_CODE_NP[np.take_along_axis(codes, rev_idx, 1)]
            vals = (rc.astype(np.uint64) + np.uint64(1)) * rpow[:L]
            PHr = np.zeros((B, L + 1), dtype=np.uint64)
            np.cumsum(vals, axis=1, out=PHr[:, 1:])

            phf_L = PHf[bidx, lengths]
            phr_L = PHr[bidx, lengths]
            # interior full-variant hashes, [6, B]
            vfull = np.stack(
                [
                    phf_L,
                    (phf_L - PHf[:, 1]) * rinv1,
                    PHf[bidx, lengths - 1],
                    phr_L,
                    (phr_L - PHr[:, 1]) * rinv1,
                    PHr[bidx, lengths - 1],
                ]
            )
            kk = np.int64(k)
            anch = np.stack(
                [
                    PHf[:, kk],
                    (PHf[:, kk + 1] - PHf[:, 1]) * rinv1,
                    PHr[:, kk],
                    (PHr[:, kk + 1] - PHr[:, 1]) * rinv1,
                ]
            )

            A = self.anchor_hash
            for grp in range(4):
                q = anch[grp]
                lo = np.searchsorted(A, q, side="left")
                hi = np.searchsorted(A, q, side="right")
                cnt = np.where(active, hi - lo, 0).astype(np.int64)
                total = int(cnt.sum())
                if total == 0:
                    continue
                owner = np.repeat(bidx, cnt)
                starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
                ai = lo[owner] + (np.arange(total) - starts[owner])
                row = self.anchor_row[ai]
                pos = self.anchor_pos[ai].astype(np.int64)
                plen = self.path_len[row].astype(np.int64)
                s = self.ph_start[row]
                tfree_c = self.tfree[row]
                h_over = (
                    self.ph[s + plen] - self.ph[s + pos]
                ) * self.rinv[pos]
                # qlen only meaningful on overhang rows (~interior, where
                # qlen < variant len <= L); clip for safe fancy-indexing
                qlen = np.minimum(plen - pos, np.int64(L - 1))
                for v in GROUP_VARS[grp]:
                    lb = lengths[owner] - (0 if v in (0, 3) else 1)
                    interior = pos + lb <= plen
                    h_int = (
                        self.ph[s + np.minimum(pos + lb, plen)]
                        - self.ph[s + pos]
                    ) * self.rinv[pos]
                    ok_int = interior & (h_int == vfull[v][owner])
                    if v in (0, 2):
                        vpref = PHf[owner, qlen]
                    elif v == 1:
                        vpref = (PHf[owner, qlen + 1] - PHf[owner, 1]) * rinv1
                    elif v in (3, 5):
                        vpref = PHr[owner, qlen]
                    else:
                        vpref = (PHr[owner, qlen + 1] - PHr[owner, 1]) * rinv1
                    ok_over = (~interior) & tfree_c & (h_over == vpref)
                    ok = ok_int | ok_over
                    n_ok = int(ok.sum())
                    if n_ok:
                        m_b.append(owner[ok])
                        m_var.append(np.full(n_ok, v, np.int8))
                        m_row.append(row[ok])
                        m_pos.append(pos[ok].astype(np.int32))
                    # N-row candidates whose literal hash failed may still
                    # match with path-N wildcards -> byte verify
                    sus = ~ok & self.nrow[row]
                    n_sus = int(sus.sum())
                    if n_sus:
                        s_b.append(owner[sus])
                        s_var.append(np.full(n_sus, v, np.int8))
                        s_row.append(row[sus])
                        s_pos.append(pos[sus].astype(np.int32))

            # ---- mini join (graph-gated): <k overhangs + N segments -----
            nc = len(c_read)
            if len(self.mini_hash) and L > k and nc:
                qs = np.arange(1, k, dtype=np.int64)
                mixq = self.len_mix[qs]
                prefs = (
                    PHf[:, 1:k] ^ mixq,
                    ((PHf[:, 2 : k + 1] - PHf[:, 1:2]) * rinv1) ^ mixq,
                    PHr[:, 1:k] ^ mixq,
                    ((PHr[:, 2 : k + 1] - PHr[:, 1:2]) * rinv1) ^ mixq,
                )
                MH = self.mini_hash
                cg_mix = self.g_mix[c_g]
                for grp in range(4):
                    qv = prefs[grp][c_read] ^ cg_mix[:, None]  # [nc, k-1]
                    qv = qv.ravel()
                    loh = np.searchsorted(MH, qv, side="left")
                    hih = np.searchsorted(MH, qv, side="right")
                    cntf = (hih - loh).astype(np.int64)
                    total = int(cntf.sum())
                    if total == 0:
                        continue
                    ownerq = np.repeat(np.arange(nc * (k - 1)), cntf)
                    starts = np.concatenate(([0], np.cumsum(cntf[:-1])))
                    ai = loh[ownerq] + (np.arange(total) - starts[ownerq])
                    owner = c_read[ownerq // (k - 1)]
                    row = self.mini_row[ai]
                    pos = self.mini_pos[ai].astype(np.int32)
                    is_over = self.mini_typ[ai] == 0
                    for v in GROUP_VARS[grp]:
                        if is_over.any():
                            m_b.append(owner[is_over])
                            m_var.append(
                                np.full(int(is_over.sum()), v, np.int8)
                            )
                            m_row.append(row[is_over])
                            m_pos.append(pos[is_over])
                        if (~is_over).any():
                            s_b.append(owner[~is_over])
                            s_var.append(
                                np.full(int((~is_over).sum()), v, np.int8)
                            )
                            s_row.append(row[~is_over])
                            s_pos.append(pos[~is_over])

            # ---- q=0 probes at path-N positions of combo graphs ---------
            if len(self.npos_gi) and nc:
                nlo = np.searchsorted(self.npos_gi, c_g, side="left")
                nhi = np.searchsorted(self.npos_gi, c_g, side="right")
                cnt = (nhi - nlo).astype(np.int64)
                total = int(cnt.sum())
                if total:
                    owner = np.repeat(np.arange(nc), cnt)
                    starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
                    ai = nlo[owner] + (np.arange(total) - starts[owner])
                    for v in range(6):
                        s_b.append(c_read[owner])
                        s_var.append(np.full(total, v, np.int8))
                        s_row.append(self.npos_row[ai])
                        s_pos.append(self.npos_pos[ai])

        # ---- byte-verify suspects, dedup, merge --------------------------
        if s_b:
            cb = np.concatenate(s_b)
            cv = np.concatenate(s_var).astype(np.int64)
            crow = np.concatenate(s_row).astype(np.int64)
            cpos = np.concatenate(s_pos).astype(np.int64)
            pk = (((cb * 8 + cv) * self.R + crow) << self._pos_bits) | cpos
            _, uniq = np.unique(pk, return_index=True)
            cb, cv, crow, cpos = cb[uniq], cv[uniq], crow[uniq], cpos[uniq]
            ok = self._verify_candidates(
                cb, cv, crow, cpos, codes, rc, lengths
            )
            if ok.any():
                m_b.append(cb[ok])
                m_var.append(cv[ok].astype(np.int8))
                m_row.append(crow[ok].astype(np.int32))
                m_pos.append(cpos[ok].astype(np.int32))

        if m_b:
            mb = np.concatenate(m_b)
            mv = np.concatenate(m_var)
            mr = np.concatenate(m_row)
            mp = np.concatenate(m_pos)
        else:
            mb = np.empty(0, np.int64)
            mv = np.empty(0, np.int8)
            mr = np.empty(0, np.int32)
            mp = np.empty(0, np.int32)
        mg = self.path_graph[mr] if len(mr) else np.empty(0, np.int32)
        mkey = mb.astype(np.int64) * self.G + mg
        order = np.argsort(mkey, kind="stable")
        return mb[order], mv[order], mr[order], mp[order], mkey[order], rc

    def process_batch(
        self, batch, rows, wins, combo_start, kc_read, acc, bam_writer, stats
    ) -> None:
        """Align every (read, graph) combo of a batch: weight replay, BAM
        records, stats."""
        t = self.tables
        n_pairs = len(rows)
        if n_pairs == 0:
            return
        codes = np.asarray(batch.codes)
        lengths = np.asarray(batch.lengths).astype(np.int64)
        k = self.k
        self._ensure_pow(codes.shape[1] + 2)

        combo_end = np.append(combo_start[1:], n_pairs)
        c_read = rows[combo_start]
        c_g = np.searchsorted(t.graph_ids, t.w_graph[wins[combo_start]])
        # fallback combos: reads too short for the k-anchor (clip variants
        # need len-1 >= k); everything else, wildcards included, is hashed
        c_fb = lengths[c_read] <= k

        rc = None
        res = None
        phf = phr = None
        if not os.environ.get("GROOT_NO_NATIVE_CASCADE"):
            from ..io import native

            res = native.find_matches(
                self, codes, lengths, c_read[~c_fb], c_g[~c_fb]
            )
        if res is not None:
            m_b, m_var, m_row, m_pos, mkey, phf, phr, ph_row = res
        else:
            active = np.zeros(len(codes), dtype=bool)
            active[c_read[~c_fb]] = True
            m_b, m_var, m_row, m_pos, mkey, rc = self._find_matches(
                codes, lengths, active, c_read[~c_fb], c_g[~c_fb]
            )

        # ---- combo match segments ----------------------------------------
        ckey = c_read.astype(np.int64) * self.G + c_g
        c_mlo = np.searchsorted(mkey, ckey, side="left")
        c_mhi = np.searchsorted(mkey, ckey, side="right")
        c_mcnt = np.where(c_fb, 0, c_mhi - c_mlo)
        pair_cnt = combo_end - combo_start
        n_combos = len(c_read)
        combo_of_pair = np.repeat(np.arange(n_combos), pair_cnt)

        # ---- staged winner evaluation ------------------------------------
        # native single pass with the reference's early exit
        # (graphminion.go:60-99) when libgrootio is available; vectorized
        # numpy fallback otherwise
        from ..io import native

        res = None
        if phf is not None:
            # the native match list holds only full-variant matches; the
            # native cascade probes clip variants lazily (stage 3/4)
            res = native.cascade(
                c_mlo, c_mcnt, combo_start, pair_cnt, c_fb,
                m_var, m_row, m_pos,
                t.w_seed_grow[wins], t.w_off[wins], t.w_span[wins],
                t.cn_ptr[wins], t.cn_cnt[wins], t.cn_grow,
                self.node_base, self.node_g, self.g_first_row,
                self.npos_dense, self.node_len,
                NODE_SHUFFLES,
                c_read, codes, lengths, ph_row, phf, phr,
                self.rinv, self.ph, self.ph_start, self.path_len,
                self.tfree.astype(np.uint8), self.nrow.astype(np.uint8),
                self.flat_codes, self.flat_start,
                len(m_var) + n_combos * self._max_paths + 1024,
            )
            if res is None:
                # native cascade unavailable mid-run: redo the search with
                # the numpy engine (its match list carries clip variants)
                active = np.zeros(len(codes), dtype=bool)
                active[c_read[~c_fb]] = True
                m_b, m_var, m_row, m_pos, mkey, rc = self._find_matches(
                    codes, lengths, active, c_read[~c_fb], c_g[~c_fb]
                )
                c_mlo = np.searchsorted(mkey, ckey, side="left")
                c_mhi = np.searchsorted(mkey, ckey, side="right")
                c_mcnt = np.where(c_fb, 0, c_mhi - c_mlo)
        if res is not None:
            cwin, c_ori8, c_stage8, id_combo, id_row, id_pos = res
            win = cwin.astype(np.int64)
            n_weighted = np.where(
                win >= 0, win - combo_start + 1, pair_cnt
            )
            combo_ori = c_ori8.astype(np.int64)
            combo_stage = c_stage8.astype(np.int64)
            id_row = id_row.astype(np.int64)
            id_pos = id_pos.astype(np.int64)
        else:
            win, n_weighted, combo_ori, combo_stage, id_combo, id_row, id_pos = (
                self._winners_np(
                    n_pairs, wins, combo_start, c_fb, c_mlo, c_mcnt,
                    combo_of_pair, pair_cnt, m_var, m_row, m_pos,
                )
            )
        combo_cs = (combo_stage == 3).astype(np.int16)
        combo_ce = (combo_stage == 4).astype(np.int16)
        fb_extra = np.zeros(n_combos, dtype=bool)
        has_win = (win >= 0) & ~c_fb

        # dedup (combo, row): one record per matching path; pid order ==
        # prow order within a graph (path_ids sorted), primary first
        o = np.lexsort((id_pos, id_row, id_combo))
        id_combo, id_row, id_pos = id_combo[o], id_row[o], id_pos[o]
        if len(id_combo):
            keep = np.ones(len(id_combo), dtype=bool)
            keep[1:] = (id_combo[1:] != id_combo[:-1]) | (
                id_row[1:] != id_row[:-1]
            )
            id_combo, id_row, id_pos = (
                id_combo[keep], id_row[keep], id_pos[keep],
            )

        # byte verification of every winning match (collision guard): a
        # failed combo is retried on the legacy engine
        if len(id_combo):
            vvar = combo_ori[id_combo] * 3 + np.where(
                combo_cs[id_combo] == 1, 1,
                np.where(combo_ce[id_combo] == 1, 2, 0),
            )
            okv = self._verify_candidates(
                c_read[id_combo], vvar, id_row, id_pos, codes, rc, lengths
            )
            if not okv.all():
                bad = np.unique(id_combo[~okv])
                fb_extra[bad] = True
                log.warning(
                    "hash verification failed for %d combos; retrying on "
                    "the legacy aligner", len(bad),
                )
        # a winning combo must produce >= 1 record; if id recovery somehow
        # missed, fall back rather than emit nothing
        present = np.zeros(n_combos, dtype=bool)
        present[id_combo] = True
        missed = has_win & ~present
        if missed.any():
            fb_extra[missed] = True
            log.warning(
                "%d winning combos had no recoverable ids; legacy retry",
                int(missed.sum()),
            )
        good = ~fb_extra[id_combo]
        id_combo, id_row, id_pos = id_combo[good], id_row[good], id_pos[good]

        # ---- weight replay (fallback combos weight inside legacy) -------
        all_fb = c_fb | fb_extra
        lim = combo_start + n_weighted
        sel = np.arange(n_pairs, dtype=np.int64) < lim[combo_of_pair]
        sel &= ~all_fb[combo_of_pair]
        if sel.any():
            acc.add_pairs(wins[sel], kc_read[rows[sel]])

        if len(id_combo):
            self._emit_flat(
                batch, c_read, id_combo, id_row, id_pos,
                combo_ori, combo_cs, combo_ce, bam_writer, stats,
            )

        # ---- fallback combos --------------------------------------------
        fb_items: Dict[int, List] = {}
        for ci in np.flatnonzero(all_fb):
            gid = int(t.graph_ids[c_g[ci]])
            read = batch.read(int(c_read[ci]))
            fb_items.setdefault(gid, []).append(
                (
                    read,
                    [
                        self.keys[w]
                        for w in wins[combo_start[ci] : combo_end[ci]]
                    ],
                    float(kc_read[c_read[ci]]),
                )
            )
        if fb_items:
            with self._fb_lock:  # legacy path mutates shared graph weights
                for gid, items in fb_items.items():
                    graph = self.store[gid]
                    results = self.legacy.align_read_batch(graph, items)
                    for records, _nw in results:
                        stats.alignment_count += len(records)
                        if bam_writer is not None:
                            for rec in records:
                                bam_writer.write(rec)
        return

    def _winners_np(
        self, n_pairs, wins, combo_start, c_fb, c_mlo, c_mcnt,
        combo_of_pair, pair_cnt, m_var, m_row, m_pos,
    ):
        """Vectorized numpy winner evaluation (fallback for gio_cascade).
        Returns (win, n_weighted, combo_ori, combo_stage, id_combo,
        id_row, id_pos) with ids pre-dedup."""
        t = self.tables
        n_combos = len(c_mlo)
        pm_cnt = c_mcnt[combo_of_pair]
        total_pm = int(pm_cnt.sum())
        pm_pair = np.repeat(np.arange(n_pairs), pm_cnt)
        pm_starts = np.concatenate(([0], np.cumsum(pm_cnt[:-1])))
        pm_mi = c_mlo[combo_of_pair][pm_pair] + (
            np.arange(total_pm) - pm_starts[pm_pair]
        )

        w_pm = wins[pm_pair]
        sg = t.w_seed_grow[w_pm]
        soff = t.w_off[w_pm].astype(np.int64)
        span = t.w_span[w_pm].astype(np.int64)
        slen = self.node_len[sg].astype(np.int64)
        mrow_pm = m_row[pm_mi].astype(np.int64)
        mpos_pm = m_pos[pm_mi].astype(np.int64)
        mvar_pm = m_var[pm_mi]
        ori_pm = (mvar_pm >= 3).astype(np.int64)
        kind_pm = (mvar_pm % 3).astype(np.int64)

        sfound, spos = self._npos_lookup(sg, mrow_pm)
        j1 = mpos_pm - spos - soff
        okA = sfound & (soff < slen)
        ok1 = (
            okA
            & (kind_pm == 0)
            & (j1 >= 0)
            & (j1 <= np.minimum(span, slen - 1 - soff))
        )
        at_seed = okA & (mpos_pm == spos + soff)
        ok3 = at_seed & (kind_pm == 1)
        ok4 = at_seed & (kind_pm == 2)

        # stage 2: expand kind==0 pm rows over the pair's contained nodes
        full_sel = np.flatnonzero(kind_pm == 0)
        cn_of = t.cn_cnt[w_pm[full_sel]].astype(np.int64)
        s2_total = int(cn_of.sum())
        s2_pm = np.repeat(full_sel, cn_of)
        s2_starts = np.concatenate(([0], np.cumsum(cn_of[:-1])))
        s2_rank = np.arange(s2_total) - s2_starts[
            np.repeat(np.arange(len(full_sel)), cn_of)
        ]
        s2_grow = t.cn_grow[t.cn_ptr[w_pm[s2_pm]] + s2_rank]
        cfound, cpos = self._npos_lookup(s2_grow, mrow_pm[s2_pm])
        sh = mpos_pm[s2_pm] - cpos
        clen = self.node_len[s2_grow].astype(np.int64)
        ok2 = cfound & (sh >= 0) & (sh <= np.minimum(NODE_SHUFFLES, clen - 1))
        key2 = s2_rank * (NODE_SHUFFLES + 1) + sh

        # ---- per (pair, ori) stage reductions ---------------------------
        slot_pm = pm_pair * 2 + ori_pm
        best1 = np.full(n_pairs * 2, BIG, dtype=np.int64)
        np.minimum.at(best1, slot_pm[ok1], j1[ok1])
        best2 = np.full(n_pairs * 2, BIG, dtype=np.int64)
        slot_s2 = slot_pm[s2_pm]
        np.minimum.at(best2, slot_s2[ok2], key2[ok2])
        has3 = np.zeros(n_pairs * 2, dtype=bool)
        has3[slot_pm[ok3]] = True
        has4 = np.zeros(n_pairs * 2, dtype=bool)
        has4[slot_pm[ok4]] = True

        b1 = best1.reshape(n_pairs, 2)
        b2 = best2.reshape(n_pairs, 2)
        h3 = has3.reshape(n_pairs, 2)
        h4 = has4.reshape(n_pairs, 2)
        ori_ok = (b1 < BIG) | (b2 < BIG) | h3 | h4
        pair_found = ori_ok.any(axis=1)
        pair_ori = np.where(ori_ok[:, 0], 0, 1)
        ar = np.arange(n_pairs)
        sel_b1 = b1[ar, pair_ori]
        sel_b2 = b2[ar, pair_ori]
        sel_h3 = h3[ar, pair_ori]
        pair_stage = np.where(
            sel_b1 < BIG, 1, np.where(sel_b2 < BIG, 2, np.where(sel_h3, 3, 4))
        )

        # s2 rows are grouped by pm row (ascending), hence by pair
        s2_pair = pm_pair[s2_pm] if s2_total else np.empty(0, np.int64)

        # ---- winner ids --------------------------------------------------
        win, n_weighted = winners(pair_found, combo_start)
        has_win = (win >= 0) & ~c_fb
        win_pairs = win[has_win]
        pair_win = np.zeros(n_pairs, dtype=bool)
        pair_win[win_pairs] = True

        # per-combo winning (ori, stage) -> cs/ce/variant
        combo_ori = np.zeros(n_combos, dtype=np.int64)
        combo_stage = np.zeros(n_combos, dtype=np.int64)
        wc = np.flatnonzero(has_win)
        combo_ori[wc] = pair_ori[win_pairs]
        combo_stage[wc] = pair_stage[win_pairs]

        stage_pm = pair_stage[pm_pair] if total_pm else np.empty(0, np.int64)
        ids_mask = (
            pair_win[pm_pair]
            & (ori_pm == pair_ori[pm_pair])
            & (
                ((stage_pm == 1) & ok1 & (j1 == sel_b1[pm_pair]))
                | ((stage_pm == 3) & ok3)
                | ((stage_pm == 4) & ok4)
            )
        )
        if s2_total:
            s2_hit = (
                pair_win[s2_pair]
                & (pair_stage[s2_pair] == 2)
                & ok2
                & (key2 == sel_b2[s2_pair])
                & (ori_pm[s2_pm] == pair_ori[s2_pair])
            )
            ids_mask[s2_pm[s2_hit]] = True

        id_pm = np.flatnonzero(ids_mask)
        id_combo = combo_of_pair[pm_pair[id_pm]]
        id_row = mrow_pm[id_pm]
        id_pos = mpos_pm[id_pm]
        return win, n_weighted, combo_ori, combo_stage, id_combo, id_row, id_pos

    # ------------------------------------------------------------------
    def _emit_flat(
        self, batch, c_read, id_combo, id_row, id_pos,
        combo_ori, combo_cs, combo_ce, bam_writer, stats,
    ) -> None:
        """Bulk BAM emission for all winning combos of a batch. Records of
        one combo share the read payload; rows come pid-sorted so the first
        record per group is primary (alignment.go:140-147). All payload
        extraction (orientation, clipping, quals) is vectorized over the
        batch's concatenated byte arrays."""
        stats.alignment_count += len(id_combo)
        if bam_writer is None:
            return
        bounds = np.ones(len(id_combo), dtype=bool)
        bounds[1:] = id_combo[1:] != id_combo[:-1]
        starts = np.flatnonzero(bounds)
        grp_combo = id_combo[starts]
        group_ptr = np.append(starts, len(id_combo)).astype(np.int64)

        rows = c_read[grp_combo]
        G = len(rows)
        rev = combo_ori[grp_combo] == 1
        cs = combo_cs[grp_combo].astype(np.int64)
        ce = combo_ce[grp_combo].astype(np.int64)

        if not os.environ.get("GROOT_NO_NATIVE_CASCADE") and hasattr(
            bam_writer, "write_raw"
        ):
            # whole-batch native assembly: oriented gather, nibble packing,
            # headers and cigars in one C pass (gio_emit_records). Payloads
            # are gathered only for the winning reads (the metagenome case
            # maps ~1% of a batch; extracting all of it cost ~10%).
            from ..io import native

            uniq = np.unique(rows)
            (idc, ido, idl, sqc, sqo, sql, quc, quo, qul) = batch.payloads(
                uniq
            )
            rloc = np.searchsorted(uniq, rows)
            Lr = sql[rloc]
            olen = Lr - cs - ce
            ncig = 1 + (cs > 0) + (ce > 0)
            per_rec = 36 + (idl[rloc] + 1) + 4 * ncig + (olen + 1) // 2 + olen
            cap = int((per_rec * np.diff(group_ptr)).sum())
            out = native.emit_records(
                idc, ido[rloc], idl[rloc],
                sqc, sqo[rloc], Lr,
                quc, quo[rloc], qul[rloc],
                rev, combo_cs[grp_combo], combo_ce[grp_combo],
                group_ptr,
                self.ref_id_by_prow[id_row], id_pos.astype(np.int64),
                cap,
            )
            if out is not None:
                bam_writer.write_raw(out, len(id_combo))
                return

        (idc, ido, idl, sqc, sqo, sql, quc, quo, qul) = batch.payloads()
        Lr = sql[rows]
        out_len = Lr - cs - ce
        out_off = np.concatenate(([0], np.cumsum(out_len[:-1])))
        total = int(out_len.sum())
        own = np.repeat(np.arange(G), out_len)
        loc = np.arange(total) - out_off[own]
        # oriented source index: fwd = off + cs + loc;
        # rc  = off + (Lr-1) - (cs + loc)  (reverse, then complement)
        fwd_src = sqo[rows][own] + cs[own] + loc
        rc_src = sqo[rows][own] + (Lr[own] - 1) - (cs[own] + loc)
        rev_b = rev[own]
        src = np.where(rev_b, rc_src, fwd_src)
        seq_out = sqc[src]
        if rev.any():
            seq_out[rev_b] = self._rc_lut[seq_out[rev_b]]
        has_q = qul[rows] == sql[rows]
        qual_out = np.zeros(total, np.uint8)
        hq_b = has_q[own]
        if has_q.any():
            q_src = np.where(
                rev_b, quo[rows][own] + (Lr[own] - 1) - (cs[own] + loc),
                quo[rows][own] + cs[own] + loc,
            )
            qual_out[hq_b] = quc[q_src[hq_b]]

        bam_writer.write_groups(
            idc, ido[rows], idl[rows],
            seq_out, out_off, out_len,
            qual_out, has_q,
            group_ptr,
            self.ref_id_by_prow[id_row],
            id_pos.astype(np.int64),
            rev,
            combo_cs[grp_combo],
            combo_ce[grp_combo],
        )
