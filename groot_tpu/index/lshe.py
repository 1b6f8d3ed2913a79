"""LSH containment index (from-scratch, batch-friendly LSH Ensemble).

Reference: /root/reference/src/lshe/lshe.go wraps ekzhu/lshensemble (Zhu et
al., VLDB'16). In groot every indexed domain has the SAME size
(NumWindowKmers = windowSize - kmerSize + 1, src/pipeline/index.go:187-188),
so the ensemble's equi-depth size partitioning is degenerate — a single
banded MinHash LSH with the containment<->jaccard conversion reproduces the
post-filtered hit set (lshe.go:153-175 re-verifies every LSH candidate with
an exact signature containment estimate, which is what makes the banding
recall-tolerant: err permissive, never restrictive).

Device-side layout: for each K in 1..maxK (K = hash funcs per band,
L_K = sketchSize // K bands) a band table

  band_sigs  uint32 [L_K, N]  (sorted per band; 32-bit mix of the K slots —
                               collisions only ADD candidates, the exact
                               containment post-filter removes them)
  band_idx   int32  [L_K, N]  (argsort permutation -> window index)

Query = band-sig mix -> vmapped searchsorted -> bounded gather (cap M per
band) -> dedup -> exact containment on gathered sketches. All fixed-shape.

The (K, L) used per query is chosen like lshensemble's OptimalKL: maximise
band-collision recall at the jaccard threshold implied by the containment
threshold; we pick the largest K whose expected false-negative rate is
below 1e-6, falling back to K=1 (most permissive)."""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import u64
from .window import Key

# jax is imported lazily: the host index/query paths never need a device

MAX_PER_BAND = 24  # max candidates gathered per (read, band) before dedup


def _mix_bands_np(sketch_u64: np.ndarray, K: int) -> np.ndarray:
    """[N, s] uint64 -> [N, L] uint32 band signatures (host build)."""
    N, s = sketch_u64.shape
    L = s // K
    use = sketch_u64[:, : L * K].reshape(N, L, K)
    # pure 32-bit FNV-style mix — MUST match _mix_bands_jax op for op
    h = np.full((N, L), 2166136261, dtype=np.uint32)
    prime = np.uint32(16777619)
    with np.errstate(over="ignore"):
        for j in range(K):
            v = use[:, :, j]
            h = (h ^ (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)) * prime
            h = (h ^ (v >> np.uint64(32)).astype(np.uint32)) * prime
    return h


def _mix_bands_jax(hi, lo, K: int):
    """(hi, lo) [B, s] uint32 -> [B, L] uint32 band signatures (device)."""
    import jax.numpy as jnp

    B, s = hi.shape
    L = s // K
    uhi = hi[:, : L * K].reshape(B, L, K)
    ulo = lo[:, : L * K].reshape(B, L, K)
    h = jnp.full((B, L), 2166136261 & 0xFFFFFFFF, dtype=jnp.uint32)
    # 32-bit FNV-style mix tracking only the low 32 bits of the host mix:
    # (h ^ v) * p mod 2^32 == low32((H ^ v) * p) when H's low 32 bits == h
    prime = jnp.uint32(16777619)
    for j in range(K):
        h = (h ^ ulo[:, :, j]) * prime
        h = (h ^ uhi[:, :, j]) * prime
    return h


class _KeysView:
    """Sequence view over the struct-of-arrays index: materialises Key
    objects lazily (only LSH-hit windows ever need one — the fallback
    aligner and the legacy dict query path)."""

    def __init__(self, soa: dict):
        self._soa = soa

    def __len__(self) -> int:
        return len(self._soa["w_graph"])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        s = self._soa
        lo, hi = int(s["cn_ptr"][i]), int(s["cn_ptr"][i + 1])
        rlo, rhi = int(s["ref_ptr"][i]), int(s["ref_ptr"][i + 1])
        return Key(
            graph_id=int(s["w_graph"][i]),
            node=int(s["w_node"][i]),
            offset=int(s["w_off"][i]),
            contained_nodes=dict(
                zip(s["cn_seg"][lo:hi].tolist(), s["cn_val"][lo:hi].tolist())
            ),
            ref=s["ref_ids"][rlo:rhi].tolist(),
            sketch=s["sketches"][i],
            merge_span=int(s["w_merge_span"][i]),
            window_size=int(s["w_window_size"][i]),
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclass
class ContainmentIndex:
    num_part: int
    max_k: int
    num_window_kmers: int
    sketch_size: int
    # window payloads (struct-of-arrays, index = window id)
    window_keys: List[str] = field(default_factory=list)
    keys: List[Key] = field(default_factory=list)
    sketches: Optional[np.ndarray] = None  # uint64 [N, s]
    # device tables, built by prepare()
    _tables: Optional[dict] = None

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def add_window(self, lookup: str, window: Key) -> None:
        """lshe.go:63-69 (duplicate keys are an error)."""
        if self._tables is not None:
            raise RuntimeError("index already prepared")
        if lookup in getattr(self, "_seen", set()):
            raise ValueError(
                f"duplicate window key can't be inserted into index: {lookup}"
            )
        if not hasattr(self, "_seen"):
            self._seen = set()
        self._seen.add(lookup)
        self.window_keys.append(lookup)
        self.keys.append(window)

    def prepare(self) -> None:
        """Build sorted band tables (reference defers LSH build to Load,
        lshe.go:108-147; we build once and serialise the tables)."""
        if self._tables is not None and self.sketches is not None:
            return  # v2 load: tables came from disk
        if not len(self.keys):
            raise ValueError("loaded an empty index file")
        if self.sketches is None:  # legacy add_window build path
            self.sketches = np.stack([k.sketch for k in self.keys])
        N, s = self.sketches.shape
        assert s == self.sketch_size
        tables = {}
        for K in range(1, self.max_k + 1):
            L = s // K
            if L < 1:
                continue
            sigs = _mix_bands_np(self.sketches, K)  # [N, L]
            order = np.argsort(sigs, axis=0, kind="stable")  # [N, L]
            tables[K] = {
                "sorted_sigs": np.take_along_axis(sigs, order, axis=0).T.copy(),
                "idx": order.T.astype(np.int32).copy(),  # [L, N]
            }
        self._tables = tables
        self._dev = None  # device copies built lazily (dev property)

    @property
    def num_sketches(self) -> int:
        return len(self.keys)

    @property
    def dev(self) -> dict:
        """Device-resident sketch copies for the jitted query kernel,
        materialised on first use (host-only runs never pay the transfer
        or the jax client init)."""
        if getattr(self, "_dev", None) is None:
            import jax.numpy as jnp

            shi, slo = u64.from_np(np.ascontiguousarray(self.sketches))
            gids = (
                self.soa["w_graph"]
                if hasattr(self, "soa")
                else np.array([k.graph_id for k in self.keys])
            )
            self._dev = {
                "hi": shi,
                "lo": slo,
                "graph_ids": jnp.asarray(gids.astype(np.int32)),
            }
        return self._dev

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def optimal_k(self, query_size: int, threshold: float) -> int:
        """Pick K (hash funcs per band) for a containment threshold, like
        lshensemble's OptimalKL: the jaccard threshold implied by the
        containment threshold is j* = t*q / (q + d - t*q); choose the
        largest K with false-negative prob (1 - j*^K)^L below 1e-6."""
        q, d = query_size, self.num_window_kmers
        j_star = threshold * q / (q + d - threshold * q)
        j_star = min(max(j_star, 1e-9), 1.0)
        best = 1
        for K in sorted(self._tables):
            L = self.sketch_size // K
            fn = (1.0 - j_star**K) ** L
            if fn < 1e-6:
                best = K
        return best

    def query_batch(
        self,
        sketch_hi,
        sketch_lo,
        query_sizes: np.ndarray,
        threshold: float,
    ) -> List[Dict[int, List[Key]]]:
        """Query a batch of read sketches.

        sketch_hi/lo: uint32 [B, s]; query_sizes: [B] k-mer counts.
        Returns, per read, {graphID: [Key, ...]} with keys sorted by
        (node, offset) — the graphMinion sort (graphminion.go:57)."""
        if self._tables is None:
            self.prepare()
        B = int(sketch_hi.shape[0])
        rows, wins = self.query_batch_np(
            sketch_hi, sketch_lo, query_sizes, threshold
        )
        out: List[Dict[int, List[Key]]] = [{} for _ in range(B)]
        keys = self.keys
        for b, w in zip(rows.tolist(), wins.tolist()):
            key = keys[w]
            out[b].setdefault(key.graph_id, []).append(key)
        for hits in out:
            for g in hits:
                hits[g].sort(key=lambda k: (k.node, k.offset))
        return out

    def full_equality_applies(self, query_sizes, threshold: float) -> bool:
        """True when the containment bound forces ALL s slots equal for
        every read in the batch (the query_batch_np fast-path condition and
        the validity condition for the slot-0 sketch prescreen)."""
        qs = np.asarray(query_sizes, np.float64)
        if not qs.size:
            return False
        d = float(self.num_window_kmers)
        s = self.sketch_size
        bound = s * threshold * qs / (qs + d - threshold * qs)
        return bool(np.all(bound >= s - 1))

    def slot0_prescreen(self):
        """(sorted unique slot-0 window hashes, 20-bit prefix buckets) for
        the native sketcher's full-equality prescreen (io.native.sketch).
        Built once per index."""
        t = getattr(self, "_slot0_tab", None)
        if t is None:
            from ..io.native import _prefix16

            s0 = np.unique(np.ascontiguousarray(self.sketches[:, 0]))
            t = self._slot0_tab = (s0, _prefix16(s0))
        return t

    def _build_full_table(self) -> None:
        """Full-sketch signature table for the all-slot-equality fast path
        (built once; call before sharing the index across threads)."""
        s = self.sketch_size
        fs = _mix_bands_np(self.sketches, s)[:, 0]  # [N]
        order = np.argsort(fs, kind="stable")
        fsig, forder = fs[order], order.astype(np.int64)
        fpref = np.empty(65537, np.int32)
        fpref[:65536] = np.searchsorted(
            fsig, np.arange(65536, dtype=np.uint32) << np.uint32(16)
        )
        fpref[65536] = len(fsig)
        self._full_native = (
            np.ascontiguousarray(fsig, np.uint32),
            fpref,
            np.ascontiguousarray(forder, np.int64),
            np.ascontiguousarray(self.sketches, np.uint64),
        )
        self._full_table = (fsig, forder)

    def query_batch_np(
        self,
        sketch_hi,
        sketch_lo,
        query_sizes: np.ndarray,
        threshold: float,
        force_banded: bool = False,
        q64: Optional[np.ndarray] = None,
        prescreened: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Flat-array variant of query_batch: returns (read_rows, window_ids)
        as numpy int arrays (unsorted) — the batched pipeline does all
        grouping/sorting itself (align.batch_host.sort_hits).

        Runs on the host by default: band lookups are searchsorted + gather,
        and unlike the fixed-shape device kernel the host path has no
        per-band candidate cap — exactly the reference's semantics
        (lshensemble returns every bucket collision, lshe.go:157-171).
        GROOT_DEVICE_QUERY=1 forces the device kernel.

        ``q64``: the sketcher's native u64 [B, s] output may be passed
        instead of (sketch_hi, sketch_lo) — it skips the hi/lo split and
        recombination passes entirely. ``prescreened`` marks a batch
        sketched with the slot-0 prescreen (sentinel rows skip lookup)."""
        if self._tables is None:
            self.prepare()
        if os.environ.get("GROOT_DEVICE_QUERY"):
            if sketch_hi is None:
                sketch_hi = (q64 >> np.uint64(32)).astype(np.uint32)
                sketch_lo = (q64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            return self._query_batch_np_dev(
                sketch_hi, sketch_lo, query_sizes, threshold
            )
        if q64 is not None:
            hi = lo = None
            B = int(q64.shape[0])
        else:
            hi = np.asarray(sketch_hi)
            lo = np.asarray(sketch_lo)
            B = int(hi.shape[0])

        # Full-equality fast path: containment = j(q+d)/((1+j)q) with
        # j = eq/s, so `contain > t` needs eq > s*t*q/(q+d-t*q). Whenever
        # that bound is >= s-1 for every read in the batch (true for groot's
        # standard t=0.99 with q ~ d), a hit requires ALL s slots equal —
        # the banded LSH collapses to an exact join on a full-sketch hash.
        s = self.sketch_size
        qs_all = np.asarray(query_sizes, np.float64)
        d = float(self.num_window_kmers)
        eq_bound = s * threshold * qs_all / (qs_all + d - threshold * qs_all)
        if np.all(eq_bound >= s - 1) and not force_banded:
            if not hasattr(self, "_full_table"):
                self._build_full_table()
            fsig, forder = self._full_table
            if not os.environ.get("GROOT_NO_NATIVE_CASCADE"):
                from ..io import native

                fn = self._full_native
                if q64 is not None:
                    res = native.lsh_query_full64(
                        q64, qs_all, d, threshold,
                        fn[0], fn[1], fn[2], fn[3], prescreened,
                    )
                else:
                    res = native.lsh_query_full(
                        hi, lo, qs_all, d, threshold,
                        fn[0], fn[1], fn[2], fn[3],
                    )
                if res is not None:
                    return res
            if q64 is None:
                q64 = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(
                    np.uint64
                )
            qsig = _mix_bands_np(q64, s)[:, 0]
            lo_i = np.searchsorted(fsig, qsig, side="left")
            hi_i = np.searchsorted(fsig, qsig, side="right")
            cnt = (hi_i - lo_i).astype(np.int64)
            total = int(cnt.sum())
            if total == 0:
                return np.empty(0, np.int64), np.empty(0, np.int64)
            rows = np.repeat(np.arange(B), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
            ai = lo_i[rows] + (np.arange(total) - starts[rows])
            cands = forder[ai]
            # exact verify (32-bit mix collisions) + the contain>t bound
            full_eq = (self.sketches[cands] == q64[rows]).all(axis=1)
            qs_c = qs_all[rows]
            contain = (qs_c + d) / (2.0 * qs_c)
            keep = full_eq & (contain > threshold)
            return rows[keep], cands[keep]

        if q64 is None:
            q64 = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(
                np.uint64
            )
        K = self.optimal_k(int(np.min(query_sizes)) if B else 1, threshold)
        t = self._tables[K]
        sigs = _mix_bands_np(q64, K)  # [B, L]
        sorted_sigs = t["sorted_sigs"]  # [L, N]
        idx = t["idx"]
        Lbands = sorted_sigs.shape[0]
        cand_parts: List[np.ndarray] = []
        row_parts: List[np.ndarray] = []
        for b in range(Lbands):
            lo_i = np.searchsorted(sorted_sigs[b], sigs[:, b], side="left")
            hi_i = np.searchsorted(sorted_sigs[b], sigs[:, b], side="right")
            cnt = (hi_i - lo_i).astype(np.int64)
            total = int(cnt.sum())
            if total == 0:
                continue
            owner = np.repeat(np.arange(B), cnt)
            starts = np.concatenate(([0], np.cumsum(cnt[:-1])))
            ai = lo_i[owner] + (np.arange(total) - starts[owner])
            cand_parts.append(idx[b][ai].astype(np.int64))
            row_parts.append(owner)
        if not cand_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        cands = np.concatenate(cand_parts)
        rows = np.concatenate(row_parts)
        # dedup (read, window)
        key = rows * self.num_sketches + cands
        key = np.unique(key)
        rows = key // self.num_sketches
        cands = key % self.num_sketches
        # exact containment post-filter (lshe.go:165)
        s = self.sketch_size
        q = q64[rows]  # [n, s]
        eq = (self.sketches[cands] == q).sum(axis=1)
        j = eq.astype(np.float64) / s
        qs = np.asarray(query_sizes, np.float64)[rows]
        contain = j * (qs + self.num_window_kmers) / ((1.0 + j) * qs)
        keep = contain > threshold
        return rows[keep], cands[keep]

    def _query_batch_np_dev(
        self, sketch_hi, sketch_lo, query_sizes, threshold
    ) -> Tuple[np.ndarray, np.ndarray]:
        import jax
        import jax.numpy as jnp

        B = int(sketch_hi.shape[0])
        K = self.optimal_k(int(np.min(query_sizes)) if B else 1, threshold)
        t = self._tables[K]
        if not hasattr(self, "_query_jit"):
            self._query_jit = jax.jit(
                _query_device,
                static_argnames=("K", "domain_size", "threshold"),
            )
        win_idx = self._query_jit(
            sketch_hi,
            sketch_lo,
            jnp.asarray(t["sorted_sigs"]),
            jnp.asarray(t["idx"]),
            self.dev["hi"],
            self.dev["lo"],
            jnp.asarray(np.asarray(query_sizes, dtype=np.int32)),
            K,
            self.num_window_kmers,
            threshold,
        )
        win_idx = np.asarray(win_idx)
        rows, cols = np.nonzero(win_idx >= 0)
        return rows.astype(np.int64), win_idx[rows, cols].astype(np.int64)

    # ------------------------------------------------------------------
    # serialisation (groot.lshe equivalent)
    # ------------------------------------------------------------------
    def _to_soa(self) -> dict:
        """Flatten the Key list into struct-of-arrays (one-time, at dump).
        Builds from sketch_and_index / load already carry the soa."""
        if getattr(self, "soa", None) is not None:
            return self.soa
        keys = self.keys
        N = len(keys)
        cn_ptr = np.zeros(N + 1, dtype=np.int64)
        ref_ptr = np.zeros(N + 1, dtype=np.int64)
        for i, k in enumerate(keys):
            cn_ptr[i + 1] = cn_ptr[i] + len(k.contained_nodes)
            ref_ptr[i + 1] = ref_ptr[i] + len(k.ref)
        cn_seg = np.empty(int(cn_ptr[-1]), dtype=np.int64)
        cn_val = np.empty(int(cn_ptr[-1]), dtype=np.float64)
        ref_ids = np.empty(int(ref_ptr[-1]), dtype=np.int64)
        for i, k in enumerate(keys):
            items = sorted(k.contained_nodes.items())
            o = cn_ptr[i]
            for j, (seg, val) in enumerate(items):
                cn_seg[o + j] = seg
                cn_val[o + j] = val
            ref_ids[ref_ptr[i] : ref_ptr[i + 1]] = k.ref
        return {
            "w_graph": np.array([k.graph_id for k in keys], np.int64),
            "w_node": np.array([k.node for k in keys], np.int64),
            "w_off": np.array([k.offset for k in keys], np.int32),
            "w_merge_span": np.array([k.merge_span for k in keys], np.int32),
            "w_window_size": np.array(
                [k.window_size for k in keys], np.int32
            ),
            "cn_ptr": cn_ptr,
            "cn_seg": cn_seg,
            "cn_val": cn_val,
            "ref_ptr": ref_ptr,
            "ref_ids": ref_ids,
            "sketches": np.stack([k.sketch for k in keys]),
        }

    def dump(self, file_path: str) -> None:
        """Format v2: struct-of-arrays + prebuilt band tables. Loading is
        array reads — the reference gob-decodes a Go object graph and
        re-bootstraps the LSH on every load (lshe.go:108-147); v1 of this
        file did the same with 200k+ pickled Key objects (~15s load)."""
        if self._tables is None:
            self.prepare()
        payload = {
            "version": 2,
            "num_part": self.num_part,
            "max_k": self.max_k,
            "num_window_kmers": self.num_window_kmers,
            "sketch_size": self.sketch_size,
            "window_keys": "\n".join(self.window_keys).encode(),
            "soa": self._to_soa(),
            "tables": self._tables,
        }
        with open(file_path, "wb") as fh:
            pickle.dump(payload, fh, protocol=4)

    @classmethod
    def load(cls, file_path: str) -> "ContainmentIndex":
        if os.path.getsize(file_path) == 0:
            raise ValueError("index appears empty")
        with open(file_path, "rb") as fh:
            payload = pickle.load(fh)
        self = cls(
            num_part=payload["num_part"],
            max_k=payload["max_k"],
            num_window_kmers=payload["num_window_kmers"],
            sketch_size=payload["sketch_size"],
        )
        if payload.get("version", 1) >= 2:
            self.window_keys = payload["window_keys"].decode().split("\n")
            self.soa = payload["soa"]
            self.sketches = self.soa["sketches"]
            if len(self.sketches) == 0:
                raise ValueError("loaded an empty index file")
            self.keys = _KeysView(self.soa)
            self._tables = payload["tables"]
            self._dev = None
            return self
        # legacy v1 payload (pickled Key dicts)
        self.window_keys = payload["window_keys"]
        self.keys = [
            Key(
                graph_id=k["graph_id"],
                node=k["node"],
                offset=k["offset"],
                contained_nodes=k["contained_nodes"],
                ref=k["ref"],
                sketch=k["sketch"],
                merge_span=k["merge_span"],
                window_size=k["window_size"],
            )
            for k in payload["keys"]
        ]
        if not self.keys:
            raise ValueError("loaded an empty index file")
        self.prepare()
        return self


def _query_device(
    q_hi,
    q_lo,
    sorted_sigs,  # u32 [L, N]
    band_idx,     # i32 [L, N]
    sk_hi,        # u32 [N, s]
    sk_lo,
    query_sizes,  # i32 [B]
    K: int,
    domain_size: int,
    threshold: float,
):
    """Banded LSH lookup + exact containment post-filter, fixed shapes.

    Returns (window_idx [B, C] with -1 for empty, containment [B, C])."""
    import jax
    import jax.numpy as jnp

    B, s = q_hi.shape
    Lbands, N = sorted_sigs.shape
    M = MAX_PER_BAND

    sigs = _mix_bands_jax(q_hi, q_lo, K)  # [B, L]

    def per_band(table_row, idx_row, sig_col):
        # sig_col: [B] band sigs for this band
        lo = jnp.searchsorted(table_row, sig_col, side="left")
        hi = jnp.searchsorted(table_row, sig_col, side="right")
        take = lo[:, None] + jnp.arange(M)[None, :]
        valid = take < hi[:, None]
        take = jnp.clip(take, 0, N - 1)
        wins = idx_row[take]
        return jnp.where(valid, wins, -1)

    cands = jax.vmap(per_band, in_axes=(0, 0, 1), out_axes=1)(
        sorted_sigs, band_idx, sigs
    )  # [B, L, M]
    cands = cands.reshape(B, Lbands * M)

    # dedup: sort ids, mask adjacent duplicates (-1 sorts first)
    cands = jnp.sort(cands, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=bool), cands[:, 1:] == cands[:, :-1]], axis=1
    )
    cands = jnp.where(dup, -1, cands)

    # exact containment estimate (lshensemble.Containment): jaccard from
    # matching sketch slots, converted with the known set sizes
    safe = jnp.maximum(cands, 0)
    c_hi = sk_hi[safe]  # [B, C, s]
    c_lo = sk_lo[safe]
    eq = ((c_hi == q_hi[:, None, :]) & (c_lo == q_lo[:, None, :])).sum(-1)
    j = eq.astype(jnp.float32) / s
    qs = query_sizes[:, None].astype(jnp.float32)
    contain = j * (qs + domain_size) / ((1.0 + j) * qs)
    keep = (cands >= 0) & (contain > threshold)
    return jnp.where(keep, cands, -1)
