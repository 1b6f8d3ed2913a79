"""Device hash-join cascade (aligner v6).

The host HashAligner (align/hash_join.py) verifies exact matches with an
O(1) polynomial-hash comparison and joins the read's match list against the
cascade's probe positions. That formulation is data-dependent (match lists,
searchsorted buckets) — hostile to XLA. v6 inverts it for the device: the
ENTIRE candidate set of the reference cascade
(/root/reference/src/graph/alignment.go:34-103) becomes dense grids over a
FLAT row axis, one row per REAL (mapping, path-through-seed-node) — no
padded path lanes, so work is proportional to true cascade work:

  phase A (seed_scan): stage 1 (seed offsets 0..span) + stages 3/4
    (clipped probes) for every row — one [rows, W] gather + elementwise;
  stage 2 (contained nodes x shuffles): only pairs phase A leaves
    undecided can need it — the reference stops at the first success per
    (read, graph) — and it is resolved INLINE on the host, exactly:
    interior matches enumerate from the sorted u64 anchor table and join
    against contained nodes incrementally by rank; dead-end overhang
    matches enumerate from the per-node tail-risky CSR, one tail-hash
    compare each. (An eager device grid was measured and rejected: the
    contained-node expansion is 38.7x the stage-1 row count on
    arg-annot.90, and the grid probes blindly where the anchor join
    touches only the read's ~10 true match positions.) No combo routes
    to a host-cascade re-run for stage-2 reasons.

Exact-match tests are ANCHOR CHAINS: read[0:lb] matches the path at p iff
the 32-bit k-window hash matches at offsets {0, k, 2k, ..., lb-k}
(consecutive gaps <= k => full equality, ~2^-32 false accept per anchor).
Path-side window hashes live in the unfolded table T1 [flat position,
lane j] so each row needs ONE contiguous row gather instead of one scalar
gather per anchor (tools/gather_bench.py times the gather forms).
Read length is a PER-ROW ARRAY, not a static: the anchor ladder is the
static multiples of k with per-row "required" masks, and the final
(read-length-dependent) tail anchor exploits the unfold identity
T1[p, w] == ah[p + w] — a dynamic per-row COLUMN shift becomes a second
fast ROW gather at flat position p + (lb-1-k). One compiled program
serves every read length in a batch (quality-trimmed libraries have many;
a per-length jit would compile per distinct length — r4 advisor finding).
The hash field is the LOW 32 BITS of the host engine's mod-2^64 polynomial
hash (mod 2^32 is a ring homomorphism, so device tables are host tables
truncated). Every winning record is byte-verified on the host by the same
collision guard the host engine uses (hash_join._verify_candidates), so a
false accept can only cause a logged per-combo fallback, never a wrong
record.

Overhang past a terminal-free path end (dead-end DFS partials,
alignment.go:229): anchors gate to in-path windows; every overhang tail
(avail < lb <= MAXL) is one certified PE2 path-tail-hash compare
(KA = MAXL lanes), so there is no partially-certified region.

Wildcards: a path 'N' matches any read base, which equality hashing cannot
express; combos whose graph contains any path-N run on the inherited host
cascade (counted + logged), as do reads longer than MAXL or shorter than
k+1. There are no MAX_READ/contained-node/path-count caps.
"""

from __future__ import annotations

import logging
import os
from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .aligner import NODE_SHUFFLES
from .batch_host import csr_expand, winners
from .hash_join import HashAligner

log = logging.getLogger("groot")

INF32 = np.int32(2**30)
BIG2 = np.int64(2**62)  # stage-2 (rank, shuffle) key sentinel
MAXL = 192       # longest read served on device; longer -> host residue
KA = MAXL        # overhang tail lanes: EVERY overhang (avail < lb <= MAXL)
                 # is one certified path-tail-hash compare — no partially
                 # certified region, no structural false accepts
NONE8 = 255      # u8 sentinel for "no match" in packed outputs

ROW_BUCKETS = (4096, 16384, 65536, 262144)


class _FbStats:
    """Stat sink for the host-cascade fallback call (only the alignment
    counter is produced there; mapped/multimapped were already counted)."""

    def __init__(self):
        self.alignment_count = 0


def _bucket_rows(n: int) -> int:
    for b in ROW_BUCKETS:
        if n <= b:
            return b
    return -(-n // ROW_BUCKETS[-1]) * ROW_BUCKETS[-1]


def _offsets(lcap: int, k: int):
    """Static anchor-ladder window starts (multiples of k). An anchor at o
    is REQUIRED for a row with variant length lbv iff o < lbv - k; the
    ladder plus the per-row dynamic tail anchor at lbv - k certifies
    read[0:lbv] exactly (consecutive anchor gaps <= k => full equality,
    ~2^-32 false accept per anchor)."""
    return tuple(range(0, max(min(lcap, MAXL) - k, 1), k))


def _row_gather(table, idx, width: int):
    """Row gather T[idx, :width] as ONE lax.gather with slice (1, width)."""
    from jax import lax

    shape = idx.shape
    flat = jnp.clip(idx.reshape(-1, 1), 0, table.shape[0] - 1)
    out = lax.gather(
        table,
        flat,
        lax.GatherDimensionNumbers(
            offset_dims=(1,),
            collapsed_slice_dims=(0,),
            start_index_map=(0,),
        ),
        slice_sizes=(1, width),
        mode=lax.GatherScatterMode.CLIP,
    )
    return out.reshape(*shape, width)


def _short_over(pe_r, ph_row, base, plen_r, tf_r, ok_r, cs, lbv, bound,
                rinv1):
    """Overhang candidates on the tail axis (a = matched bases =
    plen - pos, a < lbv): min stage offset j = plen - base - a over exact
    tail-hash matches on terminal-free rows, INF if none. One compare per
    candidate — the read prefix hash vs the PE2 path-tail hash. `lbv` is
    the per-row variant length array."""
    ka = jnp.arange(KA, dtype=jnp.int32)
    rhs = (
        ph_row[:, cs : cs + KA] - ph_row[:, cs : cs + 1]
    ) * (rinv1 if cs == 1 else 1)
    ok = pe_r == rhs
    j_cand = plen_r[:, None] - base[:, None] - ka
    ok &= (
        (ka >= 1)
        & (ka <= lbv[:, None] - 1)
        & (j_cand >= 0)
        & (j_cand <= bound[:, None])
        & tf_r[:, None]
        & ok_r[:, None]
    )
    return jnp.min(jnp.where(ok, j_cand, INF32), axis=-1)


@partial(jax.jit, static_argnames=("D1", "k", "offs"))
def seed_scan(
    tables: dict,
    PHf,            # i32 [B, WPH] fwd prefix hashes (device-resident)
    PHr,            # i32 [B, WPH] rc prefix hashes
    AHf,            # i32 [B, L+1-k] fwd k-window hashes per read position
    AHr,            # i32 [B, L+1-k]
    row_read,       # i32 [Nr] row into the PH/AH tables
    row_prow,       # i32 [Nr] global path row
    row_base,       # i32 [Nr] seed position in the path (spos + offset)
    row_sb,         # i32 [Nr] stage-1 offset bound (min(span, slen-1-off))
    row_lb,         # i32 [Nr] read length of the row's read (k < lb <= MAXL)
    row_valid,      # bool [Nr]
    *,
    D1: int,
    k: int,
    offs: tuple,    # static anchor ladder (_offsets of the batch L cap)
):
    """Phase A: stages 1, 3 and 4 for every (mapping, path) row, any mix of
    read lengths. Returns packed i32 [Nr]: j1_fwd | j1_rc<<8 | flags<<16
    with j1 as u8 (255 = no stage-1 match) and flags bits
    (s3f, s4f, s3r, s4r)."""
    T1 = tables["T1"]
    pe2 = tables["pe2"]
    path_len = tables["path_len"]
    ph_start = tables["ph_start"]
    tfree = tables["tfree"]
    rinv1 = tables["rinv1"]
    Lh = AHf.shape[1]  # read anchor lanes (= batch code width + 1 - k)
    assert D1 <= NONE8 - 1, "stage-1 offset overflows the u8 output"

    plen = path_len[row_prow]
    s = ph_start[row_prow]
    tf = tfree[row_prow]
    base = jnp.maximum(row_base, 0)
    rowT = _row_gather(T1, s + base, W1 := T1.shape[1])        # [Nr, W1]
    # tail-anchor rows: T1[p, w] == ah[p+w], so the per-row column shift
    # by t = lbv-k becomes a row gather at p + (lb-1-k); column 0 serves
    # the clip variants (t = lb-1-k), columns 1..D1 the full variant.
    # Full row width, the same gather form as rowT (the slice equals the
    # table row); whether a narrower slice pays is an open measurement.
    rowT2 = _row_gather(T1, s + base + (row_lb - 1 - k), W1)
    pe_r = pe2[row_prow]                                       # [Nr, KA]
    j = jnp.arange(D1, dtype=jnp.int32)
    avail1 = plen[:, None] - (row_base[:, None] + j)

    def per_ori(PH, AH):
        ph_row = PH[row_read]
        ah_row = AH[row_read]
        # read-side tail anchors (scalar per row)
        a_full = jnp.take_along_axis(
            ah_row, jnp.clip(row_lb - k, 0, Lh - 1)[:, None], axis=1
        )
        a_clip0 = jnp.take_along_axis(  # clip-end: read[0:lb-1]
            ah_row, jnp.clip(row_lb - 1 - k, 0, Lh - 1)[:, None], axis=1
        )
        # clip-start shares a_full: anchor of read[1:lb] at offset lb-1-k
        # is the k-window starting at read index 1 + (lb-1-k) = lb-k

        # full variant (cs=0, lbv=lb): interior chain grid over j
        g1 = (avail1 >= row_lb[:, None]) & row_valid[:, None] & (
            j <= row_sb[:, None]
        )
        for o in offs:
            req = (o < row_lb - k)[:, None]
            g1 &= ~req | (rowT[:, o : o + D1] == ah_row[:, o][:, None])
        g1 &= rowT2[:, 1 : 1 + D1] == a_full
        j1 = jnp.min(jnp.where(g1, j, INF32), axis=-1)
        j1s = _short_over(
            pe_r, ph_row, row_base, plen, tf, row_valid, 0, row_lb,
            row_sb, rinv1,
        )
        j1 = jnp.minimum(j1, j1s)

        zb = jnp.zeros_like(row_base)

        def clip(cs, a_tail):
            lbv = row_lb - 1
            g = (avail1[:, 0] >= lbv) & row_valid
            for o in offs:
                req = o < lbv - k
                g &= ~req | (rowT[:, o] == ah_row[:, cs + o])
            g &= rowT2[:, 0] == a_tail[:, 0]
            js = _short_over(
                pe_r, ph_row, row_base, plen, tf, row_valid, cs, lbv,
                zb, rinv1,
            )
            return g | (js == 0)

        return (
            jnp.minimum(j1, NONE8).astype(jnp.int32),
            clip(1, a_full),
            clip(0, a_clip0),
        )

    j1f, s3f, s4f = per_ori(PHf, AHf)
    j1r, s3r, s4r = per_ori(PHr, AHr)
    flags = (
        s3f.astype(jnp.int32)
        | (s4f.astype(jnp.int32) << 1)
        | (s3r.astype(jnp.int32) << 2)
        | (s4r.astype(jnp.int32) << 3)
    )
    return j1f | (j1r << 8) | (flags << 16)


class DeviceJoinAligner(HashAligner):
    """HashAligner with the cascade evaluated on the accelerator.

    Setup (tables, sidecar load, byte verification, host fallback, BAM
    emission) is inherited; only the staged winner evaluation is replaced
    by the jitted scan kernels. submit_pairs/fetch_pairs/collect_pairs let
    the pipeline overlap device compute of batch i with host work on
    earlier batches (prefers_async): one thread dispatches and drains, a
    worker pool runs the host-side collect."""

    prefers_async = True  # route through submit/collect, not process_batch

    def __init__(self, store, references=None, mesh=None):
        """`mesh` (optional jax.sharding.Mesh with a "data" axis) runs the
        seed scan data-parallel over the mesh: the hash tables replicate,
        the flat rows shard — the multi-chip data plane for the exact-
        alignment stage (SURVEY §2.3 read-batch DP; rows are independent,
        so no collectives are needed beyond the implicit all-gather of the
        sharded output)."""
        super().__init__(store, references)
        self._dev = None
        self._d1 = 208
        self.mesh = mesh
        self._sharded_cache = {}
        # per-stage accounting surfaced to bench.py / GROOT_TIMING;
        # updated from the dispatch thread and the collect workers, so
        # every update goes through tally() under the lock
        import collections
        import threading

        self.stage_times: Dict[str, float] = collections.defaultdict(float)
        self._st_lock = threading.Lock()
        self.t1_bytes = 0

    def tally(self, counts: Dict[str, float]) -> None:
        """Add `counts` into stage_times under the lock."""
        with self._st_lock:
            for key, val in counts.items():
                self.stage_times[key] += val

    # -- setup ----------------------------------------------------------
    def attach_tables(self, tables, index, k: int) -> None:
        super().attach_tables(tables, index, k)
        self._setup_device()

    def try_load(self, index, path: str, k: int):
        t = super().try_load(index, path, k)
        if t is not None:
            self._setup_device()
        return t

    def _setup_device(self) -> None:
        t = self.tables
        self._d1 = int(-(-(int(t.w_span.max()) + 1) // 16) * 16) if (
            t.num_windows
        ) else 16
        as_i32 = lambda a: jnp.asarray(np.asarray(a).astype(np.int32))
        R = self.R
        F = len(self.ph)
        k = self.k
        self._dev_ok = k < MAXL and self._d1 <= NONE8 - 1
        if not self._dev_ok:
            log.warning(
                "index (k=%d, span budget %d) outside the device cascade "
                "envelope; all combos run on the host cascade",
                k, self._d1,
            )
        # path-side window hashes (low 32 bits of the host polynomial
        # hashes; mod 2^32 is a ring homomorphism of the host's mod 2^64)
        ah = np.zeros(F, dtype=np.uint64)
        pe = np.zeros((R, KA), dtype=np.uint64)
        ka = np.arange(KA, dtype=np.int64)
        with np.errstate(over="ignore"):
            for r in range(R):
                plen = int(self.path_len[r])
                s = int(self.ph_start[r])
                n = plen - k + 1
                if n > 0:
                    pos = np.arange(n, dtype=np.int64)
                    ah[s : s + n] = (
                        self.ph[s + pos + k] - self.ph[s + pos]
                    ) * self.rinv[pos]
                w = plen - ka
                valid = w >= 0
                wv = w[valid]
                pe[r, valid] = (
                    self.ph[s + plen] - self.ph[s + wv]
                ) * self.rinv[wv]
        ah32 = jnp.asarray(ah.astype(np.uint32).view(np.int32))
        W1 = self._d1 + (MAXL - k) + 8

        @partial(jax.jit, static_argnames=("W",))
        def unfold(a, W: int):
            ap = jnp.pad(a, (0, W))
            n = a.shape[0]
            return jnp.stack([ap[w : w + n] for w in range(W)], axis=1)

        T1 = unfold(ah32, W1) if self._dev_ok else ah32[:, None]
        self.t1_bytes = int(T1.size) * T1.dtype.itemsize  # F x W1 x 4
        log.info(
            "\tdevice tables: T1 [%d, %d] i32, %d bytes",
            T1.shape[0], T1.shape[1], self.t1_bytes,
        )
        self._dev = {
            "T1": T1,
            "pe2": jnp.asarray(pe.astype(np.uint32).view(np.int32)),
            "ph_start": as_i32(self.ph_start),
            "path_len": as_i32(self.path_len),
            "tfree": jnp.asarray(self.tfree),
            "rinv1": jnp.int32(
                int(self.rinv[1]) & 0x7FFFFFFF
                | (-(2**31) if int(self.rinv[1]) & (1 << 31) else 0)
            ),
        }
        # graphs containing a path-N (wildcard) -> host fallback combos
        ghasN = np.zeros(self.G + 1, dtype=bool)
        nrows = np.flatnonzero(self.nrow)
        ghasN[self.path_graph[nrows]] = True
        self._ghasN = ghasN[: self.G]
        if not self._dev_ok:
            self._ghasN = np.ones_like(self._ghasN)
        self._read_hash_cache: Dict[Tuple[int, int], object] = {}
        self._rinv32 = jnp.asarray(
            self.rinv.astype(np.uint32).view(np.int32)
        )
        self._rpow32 = jnp.asarray(
            self.rpow.astype(np.uint32).view(np.int32)
        )
        # host npos lookup: row enumeration per (node, path lane)
        self._npg = np.diff(self.g_first_row).astype(np.int64)
        # per-window min distance of any contained-node position from a
        # terminal-free path end (gates the dead-end stage-2 tail
        # routing): computed per NODE first (the node->path expansion is
        # ~100x smaller than the per-cn-entry one), then min-reduced over
        # each window's contained nodes
        INF40 = np.int64(1) << 40
        plen64 = self.path_len.astype(np.int64)
        owner_n, prow_n, pos_n = self._expand_rows(
            np.arange(len(self.node_len), dtype=np.int64)
        )
        dist_n = np.where(
            self.tfree[prow_n], plen64[prow_n] - pos_n, INF40
        )
        node_tail = np.full(len(self.node_len), INF40, np.int64)
        np.minimum.at(node_tail, owner_n, dist_n)
        # sorted (path row, node position) keys: a stage-2 match at
        # (row, pos) needs a node starting in [pos-NS, pos] on that row
        # (its contained-node anchor), so two searchsorted probes prune
        # impossible (match x rank) rows before the rank-incremental
        # joins ever gather
        self._rowpos_key = np.sort(
            (prow_n.astype(np.int64) << 21) + pos_n
        )
        # sorted path-TAIL hash table for the inline stage-2 overhang
        # lookup (dead-end partial matches, alignment.go:229): key =
        # hash(path[plen-a : plen]) ^ amix[a] ^ gmix[graph] for every
        # terminal-free row and overhang length a in [1, min(plen,
        # MAXL-1)]. A read-prefix hash probes it like the interior anchor
        # table — true matches only, no candidate grids.
        from .hash_join import _splitmix64

        self._amix = np.array(
            [_splitmix64(a ^ 0x6A09E667F3BCC909) for a in range(MAXL + 1)],
            dtype=np.uint64,
        )
        tf_rows = np.flatnonzero(self.tfree)
        if len(tf_rows):
            plen_t = self.path_len[tf_rows].astype(np.int64)
            av = np.arange(1, MAXL, dtype=np.int64)
            okg = av[None, :] <= np.minimum(plen_t, MAXL - 1)[:, None]
            pos_t = np.maximum(plen_t[:, None] - av[None, :], 0)
            s_t = self.ph_start[tf_rows][:, None]
            with np.errstate(over="ignore"):
                th = (
                    self.ph[s_t + plen_t[:, None]] - self.ph[s_t + pos_t]
                ) * self.rinv[pos_t]
                th ^= self._amix[av][None, :]
                th ^= self.g_mix[self.path_graph[tf_rows]][:, None]
            ri, ci = np.nonzero(okg)
            order = np.argsort(th[ri, ci], kind="stable")
            self._tail_hash = th[ri, ci][order]
            self._tail_row = tf_rows[ri[order]].astype(np.int64)
            self._tail_a = av[ci[order]]
        else:
            self._tail_hash = np.empty(0, np.uint64)
            self._tail_row = np.empty(0, np.int64)
            self._tail_a = np.empty(0, np.int64)
        # presence bitmap over the low 27 hash bits: random binary search
        # into the multi-MB tail table is cache-miss bound; ~94% of
        # probes (junk RC prefixes) die on one bit test instead
        TB = 27
        bm = np.zeros(1 << (TB - 3), np.uint8)
        if len(self._tail_hash):
            bidx = (
                self._tail_hash & np.uint64((1 << TB) - 1)
            ).astype(np.int64)
            np.bitwise_or.at(
                bm, bidx >> 3, (1 << (bidx & 7)).astype(np.uint8)
            )
        self._tail_bloom = bm
        self._tail_bloom_mask = np.uint64((1 << TB) - 1)
        n_ent = len(t.cn_grow)
        went = (
            np.searchsorted(
                t.cn_ptr, np.arange(n_ent), side="right"
            ) - 1
        )
        wmin = np.full(t.num_windows, INF40, np.int64)
        np.minimum.at(wmin, went, node_tail[t.cn_grow])
        self._w_tail_min = wmin
        # per-window (seed -> path rows) CSR: stage-A row packing becomes
        # pure gathers at batch time
        wrp_parts, wrr_parts, wro_parts = [], [], []
        wr_cnt = np.zeros(t.num_windows, np.int64)
        NW = t.num_windows
        for lo in range(0, NW, 1 << 17):
            hi = min(lo + (1 << 17), NW)
            owner_w, prow_w, pos_w = self._expand_rows(t.w_seed_grow[lo:hi])
            np.add.at(wr_cnt, lo + owner_w, 1)
            wrr_parts.append(prow_w.astype(np.int32))
            wro_parts.append(pos_w.astype(np.int32))
        self._wr_cnt = wr_cnt
        self._wr_ptr = np.concatenate(([0], np.cumsum(wr_cnt)))
        self._wr_prow = (
            np.concatenate(wrr_parts) if wrr_parts else np.empty(0, np.int32)
        )
        self._wr_pos = (
            np.concatenate(wro_parts) if wro_parts else np.empty(0, np.int32)
        )

    def _read_hash_fn(self, B: int, L: int):
        """Jitted builder of the per-read tables for one batch shape:
        prefix hashes PHf/PHr [B, WPH] and k-window anchor hashes AHf/AHr
        [B, L+1-k] (fwd + reverse-complement). Inputs are the 2-BIT PACKED
        code rows + N bitmask (~2.7x fewer H2D bytes than u8 codes); the
        unpack is elementwise work on the device."""
        fn = self._read_hash_cache.get((B, L))
        if fn is not None:
            return fn
        from ..ops.nthash import RC_CODE_NP

        rc_tab = jnp.asarray(RC_CODE_NP.astype(np.int32))
        rpow = self._rpow32
        rinv = self._rinv32
        k = self.k
        WPH = max(L + 1, KA + 2)

        @jax.jit
        def build(packed, nmask, lengths):
            sh2 = jnp.arange(4, dtype=jnp.uint8) * 2
            c = ((packed[:, :, None] >> sh2[None, None, :]) & 3).reshape(
                B, L
            ).astype(jnp.int32)
            nb = ((nmask[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
                  ).reshape(B, L)
            c = jnp.where(nb == 1, 4, c)
            vals = (c + 1) * rpow[:L][None, :]
            PHf = jnp.concatenate(
                [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(vals, axis=1)],
                axis=1,
            )
            rev = jnp.clip(
                lengths[:, None] - 1 - jnp.arange(L)[None, :], 0, L - 1
            )
            rcod = rc_tab[jnp.take_along_axis(c, rev, axis=1)]
            rvals = (rcod + 1) * rpow[:L][None, :]
            PHr = jnp.concatenate(
                [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(rvals, axis=1)],
                axis=1,
            )
            na = L + 1 - k
            AHf = (PHf[:, k:] - PHf[:, :na]) * rinv[:na][None, :]
            AHr = (PHr[:, k:] - PHr[:, :na]) * rinv[:na][None, :]
            pad = WPH - (L + 1)
            if pad > 0:
                PHf2 = jnp.pad(PHf, ((0, 0), (0, pad)))
                PHr2 = jnp.pad(PHr, ((0, 0), (0, pad)))
            else:
                PHf2, PHr2 = PHf, PHr
            return PHf2, PHr2, AHf, AHr

        self._read_hash_cache[(B, L)] = build
        return build

    def _seed_scan(self, L: int):
        """seed_scan bound to this aligner's statics (anchor ladder from
        the batch code width L); shard_mapped over the mesh's data axis
        when a mesh is attached."""
        offs = _offsets(L, self.k)
        if self.mesh is None:
            return partial(seed_scan, D1=self._d1, k=self.k, offs=offs)
        fn = self._sharded_cache.get(offs)
        if fn is None:
            from jax.sharding import PartitionSpec as P

            rep, sh = P(), P("data")
            sm = jax.shard_map(
                partial(seed_scan, D1=self._d1, k=self.k, offs=offs),
                mesh=self.mesh,
                in_specs=(rep, rep, rep, rep, rep,
                          sh, sh, sh, sh, sh, sh),
                out_specs=sh,
            )
            fn = self._sharded_cache[offs] = jax.jit(sm)
        return fn

    def _near_node(self, rows, pos):
        """True where some node starts in [pos-NS, pos] on path row
        `rows` — the necessary condition for any stage-2 (rank, shuffle)
        hit at `pos`; prunes the joins to genuinely possible rows."""
        K = self._rowpos_key
        base = rows.astype(np.int64) << 21
        lo = np.searchsorted(
            K, base + np.maximum(pos - NODE_SHUFFLES, 0)
        )
        hi = np.searchsorted(K, base + pos, side="right")
        return hi > lo

    # -- row enumeration (host numpy) -----------------------------------
    def _expand_rows(self, nodes):
        """(item, node) -> flat (item, path) rows where the node lies on
        the path: returns (owner, prow, pos) with pos >= 0."""
        gi = self.node_g[nodes]
        npg = self._npg[gi]
        total = int(npg.sum())
        owner = np.repeat(np.arange(len(nodes)), npg)
        starts = np.concatenate(([0], np.cumsum(npg[:-1])))
        lane = np.arange(total, dtype=np.int64) - starts[owner]
        pos = self.npos_dense[self.node_base[nodes[owner]] + lane]
        keep = pos >= 0
        owner = owner[keep]
        prow = (self.g_first_row[gi[owner]] + lane[keep]).astype(np.int64)
        return owner, prow, pos[keep].astype(np.int64)

    # -- per-batch ------------------------------------------------------
    def submit_pairs(self, batch, rows, wins, combo_start):
        """Phase A: pack the flat stage-1/3/4 rows and launch seed_scan
        per read-length group. Only the mapped reads' code rows cross to
        the device. Returns opaque handles for collect_pairs."""
        n_pairs = len(rows)
        if n_pairs == 0:
            return []
        t = self.tables
        codes = np.asarray(batch.codes)
        lengths = np.asarray(batch.lengths).astype(np.int64)
        self._ensure_pow(codes.shape[1] + 2)

        combo_end = np.append(combo_start[1:], n_pairs)
        c_read = rows[combo_start]
        c_g = np.searchsorted(t.graph_ids, t.w_graph[wins[combo_start]])
        c_len = lengths[c_read]
        # residue -> host cascade: wildcard graphs, reads too short for
        # the anchor chain or longer than the unfolded table serves
        c_fb = self._ghasN[c_g] | (c_len <= self.k) | (c_len > MAXL)

        # ship only the distinct mapped reads (the metagenome case maps
        # ~1% of a batch), 2-bit packed + N bitmask (60 B/read at 150 bp
        # instead of 160 B), padded to a coarse row bucket to bound
        # compile count
        uniq = np.unique(rows)
        U = len(uniq)
        Bb = 64
        while Bb < U:
            Bb *= 4
        L = codes.shape[1]  # multiple of 32 (align_pipeline bucketing)
        cu = codes[uniq]
        nm = cu == 4
        c2 = np.where(nm, 0, cu)
        packed = np.zeros((Bb, L // 4), np.uint8)
        packed[:U] = (
            c2[:, 0::4]
            | (c2[:, 1::4] << 2)
            | (c2[:, 2::4] << 4)
            | (c2[:, 3::4] << 6)
        )
        nmask = np.zeros((Bb, L // 8), np.uint8)
        nmask[:U] = np.packbits(nm, axis=1, bitorder="little")
        # pad rows decode to all-A; their lb below is k+1 and valid=False
        sub_len = np.zeros(Bb, np.int32)
        sub_len[:U] = lengths[uniq]
        build = self._read_hash_fn(Bb, L)
        PHf, PHr, AHf, AHr = build(
            jnp.asarray(packed), jnp.asarray(nmask), jnp.asarray(sub_len)
        )
        self.tally(
            {"h2d_bytes": packed.nbytes + nmask.nbytes + sub_len.nbytes}
        )
        local_read = np.searchsorted(uniq, rows).astype(np.int64)

        combo_of_pair = np.repeat(
            np.arange(len(c_read)), combo_end - combo_start
        )
        pair_dev = ~c_fb[combo_of_pair]
        dev_pairs = np.flatnonzero(pair_dev)

        # flat phase-A rows over the device pairs: the (window -> seed
        # rows) expansion is index-static, precomputed at setup as a CSR
        # (per batch this is one repeat + three gathers)
        wch = wins[dev_pairs]
        sgp = t.w_seed_grow[wch]
        soff = t.w_off[wch].astype(np.int64)
        slen = self.node_len[sgp].astype(np.int64)
        sb = np.minimum(
            t.w_span[wch].astype(np.int64), slen - 1 - soff
        )
        seed_ok = soff < slen
        sel_w = np.flatnonzero(seed_ok)
        pflat, owner_l, _rank = csr_expand(
            self._wr_ptr, self._wr_cnt, wch[sel_w]
        )
        owner = sel_w[owner_l]
        prow = self._wr_prow[pflat].astype(np.int64)
        pos = self._wr_pos[pflat].astype(np.int64)
        r_pair = dev_pairs[owner]                       # global pair id
        r_base = pos + soff[owner]
        r_sb = sb[owner]
        r_read = local_read[r_pair]
        r_len = lengths[rows[r_pair]]

        calls = []
        n_rows = len(r_pair)
        for lo in range(0, max(n_rows, 1), ROW_BUCKETS[-1]):
            part = np.arange(lo, min(lo + ROW_BUCKETS[-1], n_rows))
            if n_rows == 0:
                break
            Nr = _bucket_rows(len(part))
            a_read = np.zeros(Nr, np.int32)
            a_prow = np.zeros(Nr, np.int32)
            a_base = np.zeros(Nr, np.int32)
            a_sb = np.zeros(Nr, np.int32)
            a_lb = np.full(Nr, self.k + 1, np.int32)  # inert pad length
            a_valid = np.zeros(Nr, bool)
            a_read[: len(part)] = r_read[part]
            a_prow[: len(part)] = prow[part]
            a_base[: len(part)] = r_base[part]
            a_sb[: len(part)] = r_sb[part]
            a_lb[: len(part)] = r_len[part]
            a_valid[: len(part)] = True
            out = self._seed_scan(L)(
                self._dev, PHf, PHr, AHf, AHr,
                jnp.asarray(a_read), jnp.asarray(a_prow),
                jnp.asarray(a_base), jnp.asarray(a_sb),
                jnp.asarray(a_lb), jnp.asarray(a_valid),
            )
            try:
                out.copy_to_host_async()
            except AttributeError:
                pass
            calls.append((r_pair[part], prow[part], r_base[part], out))
        state = {
            "calls": calls,
            "c_read": c_read,
            "c_g": c_g,
            "c_fb": c_fb,
            "c_len": c_len,
            "combo_start": combo_start,
            "combo_end": combo_end,
            "combo_of_pair": combo_of_pair,
            "PH": (PHf, PHr, AHf, AHr),
            "local_read": local_read,
        }
        return [state]

    def fetch_pairs(self, handles) -> None:
        """Main-thread D2H drain: materialise every seed_scan output as
        numpy. Split from collect_pairs so the dispatching thread also
        drains, in submission order, while the (pure numpy/native)
        collect runs on a worker pool overlapped with the next batches'
        device scans."""
        if not handles:
            return
        import time as _time

        t0 = _time.time()
        st = handles[0]
        st["calls"] = [
            (rp, pr, rb, np.asarray(out)) for rp, pr, rb, out in st["calls"]
        ]
        self.tally({"drain_s": _time.time() - t0})

    def collect_pairs(
        self, handles, batch, rows, wins, kc_read, acc, bam_writer, stats
    ) -> None:
        """Combine phase A results, winner selection, stage-2 routing,
        weight replay, byte verification, BAM emission and host fallbacks
        (HashAligner.process_batch's tail). Thread-safe given a per-thread
        `acc` and a per-batch `bam_writer` sink: everything here is numpy/
        native over read-only tables (fetch_pairs already drained the
        device outputs on the main thread)."""
        if not handles:
            return
        st = handles[0]
        t = self.tables
        n_pairs = len(rows)
        combo_start = st["combo_start"]
        combo_end = st["combo_end"]
        c_read, c_g, c_fb = st["c_read"], st["c_g"], st["c_fb"]
        combo_of_pair = st["combo_of_pair"]
        n_combos = len(c_read)
        codes = np.asarray(batch.codes)
        lengths = np.asarray(batch.lengths).astype(np.int64)

        import collections
        import time as _time

        # this batch's counters, merged into stage_times once at the end
        stl: Dict[str, float] = collections.defaultdict(float)
        t0 = _time.time()
        # ---- drain A: per-(pair, ori) reductions over flat rows --------
        j1 = np.full((n_pairs, 2), INF32, np.int64)
        s3 = np.zeros((n_pairs, 2), bool)
        s4 = np.zeros((n_pairs, 2), bool)
        a_rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        from ..io import native as _native

        use_nat = _native.available() and not os.environ.get(
            "GROOT_NO_NATIVE_CASCADE"
        )
        for r_pair, r_prow, r_base, out in st["calls"]:
            if len(r_pair) == 0:
                continue
            packed = np.asarray(out)[: len(r_pair)]
            a_rows.append((r_pair, r_prow, r_base, packed))
            if use_nat and _native.dev_reduce(packed, r_pair, j1, s3, s4):
                continue
            jf = packed & 0xFF
            jr = (packed >> 8) & 0xFF
            fl = packed >> 16
            # r_pair is nondecreasing (CSR expansion order): segment
            # reduceat beats ufunc.at by ~10x at this row count
            bnd = np.empty(len(r_pair), bool)
            bnd[0] = True
            np.not_equal(r_pair[1:], r_pair[:-1], out=bnd[1:])
            seg = np.flatnonzero(bnd)
            up = r_pair[seg]
            j1[up, 0] = np.minimum(
                j1[up, 0],
                np.minimum.reduceat(np.where(jf == NONE8, INF32, jf), seg),
            )
            j1[up, 1] = np.minimum(
                j1[up, 1],
                np.minimum.reduceat(np.where(jr == NONE8, INF32, jr), seg),
            )
            orf = np.bitwise_or.reduceat(fl, seg)
            s3[up, 0] |= (orf & 1) > 0
            s4[up, 0] |= (orf & 2) > 0
            s3[up, 1] |= (orf & 4) > 0
            s4[up, 1] |= (orf & 8) > 0
        s1 = j1 < INF32
        drainA = _time.time() - t0

        # ---- stage 2 ----------------------------------------------------
        # The reference's priority makes stage 2 relevant only for pairs
        # with no stage-1 success positioned at or before the current
        # winner. Both cases are resolved INLINE and exactly below
        # (interior via the anchor table, dead-end overhang via the
        # tail-risky CSR); RC-orientation junk (half of every library)
        # short-circuits on the empty anchor range.
        foundA = (s1 | s3 | s4).any(axis=1)
        winA, _nw = winners(foundA, combo_start)
        winA_of_pair = winA[combo_of_pair]
        idx = np.arange(n_pairs)
        window_b = (
            ~c_fb[combo_of_pair]
            & ((winA_of_pair < 0) | (idx <= winA_of_pair))
        )
        need_f = window_b & ~s1[:, 0]
        need_r = window_b & ~s1[:, 1] & ~(s1 | s3 | s4)[:, 0]
        fb_extra = np.zeros(n_combos, dtype=bool)
        n_needb = 0
        s2 = np.zeros((n_pairs, 2), bool)
        best2 = np.full((n_pairs, 2), BIG2, np.int64)
        s2_join: List[Tuple[np.ndarray, ...]] = []  # per-ori join rows
        bp = np.flatnonzero(need_f | need_r)
        if len(bp):
            from ..ops.nthash import RC_CODE_NP

            cand_reads = np.unique(rows[bp])
            cr = codes[cand_reads]
            crl = lengths[cand_reads]
            Lc = cr.shape[1]
            kk = self.k
            with np.errstate(over="ignore"):
                # first-k anchor hash + FULL-length variant hash, fwd + rc
                valsf = (cr.astype(np.uint64) + np.uint64(1)) * self.rpow[:Lc]
                cumf = np.cumsum(valsf, axis=1)
                ar = np.arange(len(cr))
                vf = cumf[ar, kk - 1]
                vfull_f = cumf[ar, crl - 1]
                ridx = np.clip(
                    crl[:, None] - 1 - np.arange(Lc)[None, :], 0, Lc - 1
                )
                rcod = RC_CODE_NP[np.take_along_axis(cr, ridx, axis=1)]
                valsr = (
                    rcod.astype(np.uint64) + np.uint64(1)
                ) * self.rpow[:Lc]
                cumr = np.cumsum(valsr, axis=1)
                vr = cumr[ar, kk - 1]
                vfull_r = cumr[ar, crl - 1]
            A = self.anchor_hash
            pg = self.path_graph
            # tailrisk: the pair's window has a contained-node position
            # close enough to a terminal-free path end that a dead-end
            # OVERHANG stage-2 match is possible (alignment.go:229);
            # resolved inline below from the per-node risky-row CSR
            tailrisk = (
                self._w_tail_min[wins]
                < lengths[rows] + NODE_SHUFFLES + 1
            )
            # stage 2 resolved INLINE and exactly — both cases — so no
            # combo routes to the host cascade for stage-2 reasons:
            #  * interior: the read's true full-variant interior matches
            #    are enumerated from the sorted u64 anchor table (first-k
            #    hash range -> candidates; full-length hash equality ->
            #    matches), then joined against the window's contained
            #    nodes x shuffles with the host cascade's
            #    (rank, shuffle)-lexicographic winner key
            #    (hash_join._winners_np ok2/key2);
            #  * overhang: candidates are the window's contained-node
            #    (row, pos) entries near a terminal-free path end
            #    (_risk_* CSR) x shuffles, matched by one path-tail-hash
            #    vs read-prefix-hash compare each.
            lrd = np.searchsorted(cand_reads, rows)
            safe = np.clip(lrd, 0, len(cand_reads) - 1)
            in_cand = cand_reads[safe] == rows
            t = self.tables

            def enum_matches(v_anchor, vfull):
                if use_nat:
                    res = _native.s2_enum(
                        v_anchor, vfull, crl,
                        self.anchor_hash, self.anchor_row,
                        self.anchor_pos, self._anchor_pref,
                        self.path_len, self.ph_start, self.ph, self.rinv,
                    )
                    if res is not None:
                        stl["s2_match"] += len(res[0])
                        return res
                lo = np.searchsorted(A, v_anchor)
                hi = np.searchsorted(A, v_anchor, side="right")
                cnt = (hi - lo).astype(np.int64)
                total = int(cnt.sum())
                if total == 0:
                    e = np.empty(0, np.int64)
                    return e, e, e
                stl["s2_cand"] += total
                owner = np.repeat(np.arange(len(lo)), cnt)
                starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
                ai = lo[owner] + (np.arange(total) - starts[owner])
                row = self.anchor_row[ai].astype(np.int64)
                pos = self.anchor_pos[ai].astype(np.int64)
                lbo = crl[owner]
                plen = self.path_len[row].astype(np.int64)
                s = self.ph_start[row]
                interior = pos + lbo <= plen
                with np.errstate(over="ignore"):
                    hint = (
                        self.ph[s + np.minimum(pos + lbo, plen)]
                        - self.ph[s + pos]
                    ) * self.rinv[pos]
                ok = interior & (hint == vfull[owner])
                stl["s2_match"] += int(ok.sum())
                return owner[ok], row[ok], pos[ok]

            def overhang_rows(tp, cum):
                """Dead-end overhang stage-2 candidates for pairs `tp`:
                probe the sorted path-tail hash table with the read's
                prefix hashes (one key per overhang length a) and return
                the TRUE tail matches as (pair, path row, position) rows.
                Work is proportional to matches, not candidate grids."""
                E = np.empty(0, np.int64)
                T = self._tail_hash
                if len(T) == 0:
                    return E, E, E
                # dedup probes by (read, graph): a read seeded to several
                # windows of one graph probes the tail table once
                ukey = (
                    safe[tp].astype(np.int64) * self.G
                    + c_g[combo_of_pair[tp]]
                )
                uq, inv = np.unique(ukey, return_inverse=True)
                urd = (uq // self.G).astype(np.int64)
                lb2 = crl[urd]
                amax = int(lb2.max()) - 1
                if amax < 1:
                    return E, E, E
                av = np.arange(1, amax + 1, dtype=np.int64)
                with np.errstate(over="ignore"):
                    keys = (
                        cum[urd][:, av - 1]
                        ^ self._amix[av][None, :]
                        ^ self.g_mix[(uq % self.G)][:, None]
                    )
                okq = av[None, :] <= (lb2 - 1)[:, None]
                qi, _aj = np.nonzero(okq)
                flatk = keys[okq]
                stl["s2_over_probe"] += len(flatk)
                bidx = (flatk & self._tail_bloom_mask).astype(np.int64)
                alive0 = np.flatnonzero(
                    (self._tail_bloom[bidx >> 3] >> (bidx & 7)) & 1
                )
                if len(alive0) == 0:
                    return E, E, E
                flatk = flatk[alive0]
                qi = qi[alive0]
                stl["s2_over_srch"] += len(flatk)
                lo = np.searchsorted(T, flatk)
                hi = np.searchsorted(T, flatk, side="right")
                cnt = (hi - lo).astype(np.int64)
                tot0 = int(cnt.sum())
                if tot0 == 0:
                    return E, E, E
                ow = np.repeat(np.arange(len(flatk)), cnt)
                st2 = np.concatenate(([0], np.cumsum(cnt[:-1])))
                ai = lo[ow] + (np.arange(tot0) - st2[ow])
                u_hit = qi[ow]                     # unique-(read,graph) id
                # fan hits back out to the pairs sharing the probe
                po = np.argsort(inv, kind="stable")
                ucnt = np.bincount(inv, minlength=len(uq)).astype(np.int64)
                uptr = np.concatenate(([0], np.cumsum(ucnt)))
                fan = ucnt[u_hit]
                tot = int(fan.sum())
                stl["s2_over_rows"] += tot
                hid = np.repeat(np.arange(tot0), fan)
                st4 = np.concatenate(([0], np.cumsum(fan[:-1])))
                jj = np.arange(tot) - st4[hid]
                pair2 = tp[po[uptr[u_hit[hid]] + jj]]
                hrow = self._tail_row[ai][hid]
                ha = self._tail_a[ai][hid]
                pos2 = self.path_len[hrow].astype(np.int64) - ha
                keep = self._near_node(hrow, pos2)
                return pair2[keep], hrow[keep], pos2[keep]

            for oi, (va, vfl, need_o, cum) in enumerate(
                (
                    (vf, vfull_f, need_f, cumf),
                    (vr, vfull_r, need_r, cumr),
                )
            ):
                ip = np.flatnonzero(need_o & in_cand)
                if len(ip) == 0:
                    continue
                tq2 = _time.time()
                m_owner, m_row, m_pos = enum_matches(va, vfl)
                stl["s2_enum_s"] += _time.time() - tq2
                tq2 = _time.time()
                # interior candidates fanned out per pair (near-node
                # pruned: a hit needs a node starting within NS of it)
                if len(m_owner):
                    mkey = m_owner * np.int64(self.G) + pg[m_row]
                    mo = np.argsort(mkey, kind="stable")
                    mkey, m_rowS, m_posS = mkey[mo], m_row[mo], m_pos[mo]
                    pkey = (
                        safe[ip].astype(np.int64) * self.G
                        + c_g[combo_of_pair[ip]]
                    )
                    mlo = np.searchsorted(mkey, pkey)
                    mhi = np.searchsorted(mkey, pkey, side="right")
                    cm = mhi - mlo
                    tot = int(cm.sum())
                else:
                    tot = 0
                if tot:
                    pmo = np.repeat(np.arange(len(ip)), cm)
                    st0 = np.concatenate(([0], np.cumsum(cm[:-1])))
                    mi = mlo[pmo] + (np.arange(tot) - st0[pmo])
                    pm_pair = ip[pmo]
                    e_row = m_rowS[mi]
                    e_pos = m_posS[mi]
                    keep = self._near_node(e_row, e_pos)
                    pm_pair, e_row, e_pos = (
                        pm_pair[keep], e_row[keep], e_pos[keep],
                    )
                else:
                    pm_pair = np.empty(0, np.int64)
                    e_row = np.empty(0, np.int64)
                    e_pos = np.empty(0, np.int64)
                stl["s2_int_s"] += _time.time() - tq2
                # dead-end overhang candidates (near-node pruned)
                tq4 = _time.time()
                tp = ip[tailrisk[ip]]
                if len(tp):
                    o_pair, o_row, o_pos = overhang_rows(tp, cum)
                else:
                    o_pair = o_row = o_pos = np.empty(0, np.int64)
                stl["s2_over_s"] += _time.time() - tq4
                n_all = len(pm_pair) + len(o_pair)
                if n_all == 0:
                    continue
                tq5 = _time.time()
                all_pair = np.concatenate((pm_pair, o_pair))
                all_row = np.concatenate((e_row, o_row))
                all_pos = np.concatenate((e_pos, o_pos))
                stl["s2_join_rows"] += n_all
                order = np.argsort(all_pair, kind="stable")
                all_pair = all_pair[order]
                all_row = all_row[order]
                all_pos = all_pos[order]
                bnd = np.empty(n_all, bool)
                bnd[0] = True
                np.not_equal(all_pair[1:], all_pair[:-1], out=bnd[1:])
                segs = np.flatnonzero(bnd)
                sel_pairs = all_pair[segs]
                cand_ptr = np.append(segs, n_all).astype(np.int64)
                cand_ptr = np.concatenate(([0], cand_ptr[1:]))
                res = None
                if use_nat:
                    res = _native.s2_decide(
                        sel_pairs, wins[sel_pairs].astype(np.int64),
                        cand_ptr, all_row, all_pos,
                        t.cn_ptr, t.cn_cnt, t.cn_grow,
                        self.node_base, self.node_g, self.g_first_row,
                        self.npos_dense, self.node_len, NODE_SHUFFLES,
                    )
                if res is not None:
                    bestk, id_p, id_r, id_ps, id_k = res
                    dec = bestk >= 0
                    best2[sel_pairs[dec], oi] = bestk[dec]
                    if len(id_p):
                        s2_join.append(
                            (np.full(len(id_p), oi, np.int8), id_p,
                             id_r, id_ps, id_k)
                        )
                else:
                    # numpy fallback: the same lexicographic decision,
                    # incremental over the rank axis with drop-out
                    cn_all = t.cn_cnt[all_pair_w := wins[all_pair]].astype(
                        np.int64
                    )
                    alive = np.arange(n_all)
                    r = 0
                    while len(alive):
                        has = cn_all[alive] > r
                        cur = alive[has]
                        if len(cur) == 0:
                            break
                        cur = cur[
                            best2[all_pair[cur], oi]
                            >= r * (NODE_SHUFFLES + 1)
                        ]
                        if len(cur):
                            grow = t.cn_grow[t.cn_ptr[all_pair_w[cur]] + r]
                            cfound, cpos = self._npos_lookup(
                                grow, all_row[cur]
                            )
                            sh = all_pos[cur] - cpos
                            clen = self.node_len[grow].astype(np.int64)
                            ok2 = (
                                cfound
                                & (sh >= 0)
                                & (sh <= np.minimum(
                                    NODE_SHUFFLES, clen - 1
                                ))
                            )
                            selr = np.flatnonzero(ok2)
                            if len(selr):
                                ep = all_pair[cur[selr]]
                                key2 = (
                                    r * (NODE_SHUFFLES + 1) + sh[selr]
                                )
                                np.minimum.at(best2[:, oi], ep, key2)
                                s2_join.append(
                                    (np.full(len(selr), oi, np.int8), ep,
                                     all_row[cur[selr]],
                                     all_pos[cur[selr]], key2)
                                )
                        alive = alive[has]
                        alive = alive[
                            best2[all_pair[alive], oi]
                            >= (r + 1) * (NODE_SHUFFLES + 1)
                        ]
                        r += 1
                stl["s2_dec_s"] += _time.time() - tq5
            s2 = best2 < BIG2
            n_needb = int(((need_f | need_r) & tailrisk).sum())
            stl["s2_tail_pairs"] += n_needb
            stl["s2_inline_pairs"] += int((need_f | need_r).sum())

        # ---- combine per pair ------------------------------------------
        # (overhang-risk stage-2 pairs are in fb_extra by now; interior
        # stage-2 was resolved inline above, so s2 here is live and exact)
        found_o = s1 | s2 | s3 | s4                    # [n_pairs, 2]
        found = found_o.any(axis=1)
        ori = np.where(found_o[:, 0], 0, 1)
        pick = lambda a: a[idx, ori]
        stage = np.where(
            pick(s1), 1, np.where(pick(s2), 2, np.where(pick(s3), 3, 4))
        )

        win, n_weighted = winners(found, combo_start)
        has_win = (win >= 0) & ~c_fb & ~fb_extra

        # ---- winner ids: flat rows at the winning (ori, stage, key) ----
        wc = np.flatnonzero(has_win)
        combo_ori = np.zeros(n_combos, np.int64)
        combo_stage = np.zeros(n_combos, np.int64)
        id_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if len(wc):
            wp = win[wc]
            combo_ori[wc] = ori[wp]
            combo_stage[wc] = stage[wp]
            is_winner = np.zeros(n_pairs, bool)
            is_winner[wp] = True
            pickj1 = pick(j1)
            ori_u8 = ori.astype(np.uint8)
            stage_u8 = stage.astype(np.uint8)
            for r_pair, r_prow, r_base, packed in a_rows:
                if use_nat:
                    res = _native.dev_ids(
                        packed, r_pair, r_prow, r_base, is_winner,
                        ori_u8, stage_u8, pickj1, combo_of_pair,
                    )
                    if res is not None:
                        if len(res[0]):
                            id_parts.append(res)
                        continue
                pk = packed
                w_sel = is_winner[r_pair]
                p_ori = ori[r_pair]
                p_stage = stage[r_pair]
                jsel = np.where(p_ori == 0, pk & 0xFF, (pk >> 8) & 0xFF)
                fl = pk >> 16
                ok3r = np.where(p_ori == 0, fl & 1, fl & 4) > 0
                ok4r = np.where(p_ori == 0, fl & 2, fl & 8) > 0
                hit = w_sel & (
                    ((p_stage == 1) & (jsel == pick(j1)[r_pair]))
                    | ((p_stage == 3) & ok3r)
                    | ((p_stage == 4) & ok4r)
                )
                if hit.any():
                    hsel = np.flatnonzero(hit)
                    off = np.where(
                        p_stage[hsel] == 1,
                        jsel[hsel], 0,
                    )
                    id_parts.append(
                        (
                            combo_of_pair[r_pair[hsel]],
                            r_prow[hsel],
                            r_base[hsel] + off,
                        )
                    )
            # stage-2 winners: ids from the inline interior join rows
            for s2o, ep, erow, epos, ekey in s2_join:
                hit = (
                    is_winner[ep]
                    & (stage[ep] == 2)
                    & (ori[ep] == s2o)
                    & (ekey == best2[ep, s2o])
                )
                if hit.any():
                    hsel = np.flatnonzero(hit)
                    id_parts.append(
                        (
                            combo_of_pair[ep[hsel]],
                            erow[hsel],
                            epos[hsel],
                        )
                    )
        if id_parts:
            id_combo = np.concatenate([p[0] for p in id_parts])
            id_row = np.concatenate([p[1] for p in id_parts])
            id_pos = np.concatenate([p[2] for p in id_parts])
            o = np.lexsort((id_pos, id_row, id_combo))
            id_combo, id_row, id_pos = id_combo[o], id_row[o], id_pos[o]
            dup = np.zeros(len(id_combo), bool)
            dup[1:] = (id_combo[1:] == id_combo[:-1]) & (
                id_row[1:] == id_row[:-1]
            )
            id_combo, id_row, id_pos = (
                id_combo[~dup], id_row[~dup], id_pos[~dup],
            )
        else:
            id_combo = np.empty(0, np.int64)
            id_row = np.empty(0, np.int64)
            id_pos = np.empty(0, np.int64)

        combo_cs = (combo_stage == 3).astype(np.int16)
        combo_ce = (combo_stage == 4).astype(np.int16)

        t1 = _time.time()
        if os.environ.get("GROOT_TIMING"):
            log.info(
                "\ttiming: device reduce=%.2fs callsA=%d stage2_pairs=%d "
                "stage2_combos=%d",
                drainA, len(st["calls"]), n_needb, int(fb_extra.sum()),
            )

        # ---- byte verification (32-bit collision guard) -----------------
        if len(id_combo):
            vvar = combo_ori[id_combo] * 3 + np.where(
                combo_cs[id_combo] == 1, 1,
                np.where(combo_ce[id_combo] == 1, 2, 0),
            )
            okv = self._verify_candidates(
                c_read[id_combo], vvar, id_row, id_pos, codes, None, lengths
            )
            if not okv.all():
                bad = np.unique(id_combo[~okv])
                fb_extra[bad] = True
                log.warning(
                    "device hash verification failed for %d combos; "
                    "retrying on the host cascade", len(bad),
                )
        present = np.zeros(n_combos, dtype=bool)
        present[id_combo] = True
        missed = has_win & ~present
        if missed.any():
            fb_extra[missed] = True
            log.warning(
                "%d winning combos had no recoverable ids; host retry",
                int(missed.sum()),
            )
        good = ~fb_extra[id_combo]
        id_combo, id_row, id_pos = (
            id_combo[good], id_row[good], id_pos[good],
        )

        # ---- weight replay ----------------------------------------------
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

        t2 = _time.time()
        # ---- fallback combos (wildcard graphs, long/short reads,
        # stage-2-possible pairs, verify failures): re-run through the
        # inherited HOST hash-join cascade — the fb subset of the sorted
        # hit list is itself a sorted hit list. On the pooled pipeline
        # this runs on a worker thread overlapped with the next batches'
        # device scans, so the residue costs spare host cycles, not
        # wall-clock on the device path.
        nfb = int(all_fb.sum())
        if nfb:
            log.info("\t%d combos routed to the host cascade", nfb)
            fb_pairs = np.concatenate(
                [
                    np.arange(combo_start[ci], combo_end[ci])
                    for ci in np.flatnonzero(all_fb)
                ]
            )
            fb_cnt = (combo_end - combo_start)[all_fb]
            fb_start = np.concatenate(
                ([0], np.cumsum(fb_cnt[:-1]))
            ).astype(np.int64)
            fb_stats = _FbStats()
            HashAligner.process_batch(
                self, batch, rows[fb_pairs], wins[fb_pairs], fb_start,
                kc_read, acc, bam_writer, fb_stats,
            )
            stats.alignment_count += fb_stats.alignment_count
        t3 = _time.time()
        stl["reduce_s"] += t1 - t0
        stl["verify_emit_s"] += t2 - t1
        stl["residue_s"] += t3 - t2
        stl["stage2_combos"] += int(fb_extra.sum())
        stl["fb_combos"] += nfb
        stl["combos"] += n_combos
        self.tally(stl)
