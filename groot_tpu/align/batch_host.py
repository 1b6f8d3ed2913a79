"""Flat (struct-of-arrays) window tables for the batched align path.

The reference streams one read at a time through Go maps of `lshe.Key`
records (src/lshe/lshe.go:17-28, boss.go:163-191). The batched pipeline
instead touches ~10^5 (read, window) hits per batch, so per-hit Python/dict
work is the throughput ceiling.  This module flattens every per-window
payload into numpy arrays once, after index load; per batch everything is
vectorized numpy over the LSH hit lists:

  * sort hits by (read, graph, node, offset)    — the graphMinion mapping
    sort (graphminion.go:57) and per-graph grouping in one lexsort;
  * combo (read, graph) segmentation            — np.flatnonzero on deltas;
  * contained-node probe expansion              — CSR gather (no dicts);
  * winner selection per combo                  — np.minimum.reduceat;
  * increment_subpath weight replay             — np.add.at over the CSR.

Weights accumulate into ONE global node-weight vector (row = dense
(graph, segment) numbering), flushed to the GrootGraph objects once per run
— the vector is also what the multi-chip path psums (SURVEY §2.3).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..graph.grootgraph import GrootGraph


class WindowTables:
    """Dense per-window arrays (index = window id, as in ContainmentIndex)."""

    def __init__(self, index, store: Dict[int, GrootGraph]):
        # global node rows: dense numbering of (graph, segment)
        node_row: Dict[Tuple[int, int], int] = {}
        rows: List[Tuple[int, int]] = []
        node_lens: List[float] = []
        for gid in sorted(store):
            for node in store[gid].sorted_nodes:
                node_row[(gid, node.segment_id)] = len(rows)
                rows.append((gid, node.segment_id))
                node_lens.append(node.segment_length)
        self.node_table = np.array(rows, dtype=np.int64)  # [Nn, 2]
        self.num_nodes = len(rows)
        self.graph_ids = np.array(sorted(store), dtype=np.int64)
        node_len_f = np.array(node_lens, dtype=np.float64)

        soa = getattr(index, "soa", None)
        if soa is not None:
            self._init_from_soa(soa, node_row, node_len_f)
            return

        keys = index.keys
        N = len(keys)
        self.num_windows = N
        self.w_graph = np.empty(N, dtype=np.int32)
        self.w_node = np.empty(N, dtype=np.int64)   # seed segment id
        self.w_off = np.empty(N, dtype=np.int32)
        self.w_span = np.empty(N, dtype=np.int32)   # merge_span + window_size
        self.w_multi = np.empty(N, dtype=bool)
        self.w_seed_grow = np.empty(N, dtype=np.int64)  # seed's global node row

        # contained-nodes CSR: per window, ascending segment id (the
        # deterministic stand-in for Go's random map order, SURVEY §7.3)
        cn_ptr = np.zeros(N + 1, dtype=np.int64)
        cn_grow: List[np.ndarray] = []   # global node row per entry
        cn_share: List[np.ndarray] = []  # increment_subpath share per entry
        for i, key in enumerate(keys):
            gid = key.graph_id
            graph = store[gid]
            items = sorted(key.contained_nodes.items())
            self.w_graph[i] = gid
            self.w_node[i] = key.node
            self.w_off[i] = key.offset
            self.w_span[i] = int(key.merge_span + key.window_size)
            self.w_multi[i] = len(items) > 1
            self.w_seed_grow[i] = node_row[(gid, key.node)]
            grow = np.array(
                [node_row[(gid, nid)] for nid, _ in items], dtype=np.int64
            )
            if len(items) == 1:
                share = np.ones(1, dtype=np.float64)
            else:
                lens = np.array(
                    [graph.get_node(nid).segment_length for nid, _ in items],
                    dtype=np.float64,
                )
                counts = np.array([c for _, c in items], dtype=np.float64)
                share = (lens / lens.sum()) * counts
            cn_grow.append(grow)
            cn_share.append(share)
            cn_ptr[i + 1] = cn_ptr[i] + len(items)
        self.cn_ptr = cn_ptr
        self.cn_grow = np.concatenate(cn_grow) if cn_grow else np.empty(0, np.int64)
        self.cn_share = np.concatenate(cn_share) if cn_share else np.empty(0)
        self.cn_cnt = np.diff(cn_ptr).astype(np.int32)

    def _init_from_soa(self, soa, node_row, node_len_f) -> None:
        """Vectorized build from the v2 index's struct-of-arrays (the
        per-Key Python loop above costs seconds on 200k+ windows)."""
        N = len(soa["w_graph"])
        self.num_windows = N
        self.w_graph = soa["w_graph"].astype(np.int32)
        self.w_node = soa["w_node"].astype(np.int64)
        self.w_off = soa["w_off"].astype(np.int32)
        self.w_span = (soa["w_merge_span"] + soa["w_window_size"]).astype(
            np.int32
        )
        self.cn_ptr = soa["cn_ptr"].astype(np.int64)
        self.cn_cnt = np.diff(self.cn_ptr).astype(np.int32)
        self.w_multi = self.cn_cnt > 1
        # vectorized (gid, seg) -> grow: searchsorted over packed keys
        S = int(self.node_table[:, 1].max()) + 2 if self.num_nodes else 2
        nt_key = self.node_table[:, 0] * S + self.node_table[:, 1]
        nt_order = np.argsort(nt_key, kind="stable")
        nt_sorted = nt_key[nt_order]

        def grow_of(gids, segs):
            key = gids.astype(np.int64) * S + segs.astype(np.int64)
            return nt_order[np.searchsorted(nt_sorted, key)]

        self.w_seed_grow = grow_of(soa["w_graph"], soa["w_node"])
        gid_per_entry = np.repeat(soa["w_graph"], self.cn_cnt)
        self.cn_grow = grow_of(gid_per_entry, soa["cn_seg"])
        lens = node_len_f[self.cn_grow]
        counts = soa["cn_val"].astype(np.float64)
        len_sums = np.add.reduceat(
            lens, self.cn_ptr[:-1], dtype=np.float64
        ) if N else np.empty(0)
        share = (lens / np.repeat(len_sums, self.cn_cnt)) * counts
        share[np.repeat(self.cn_cnt == 1, self.cn_cnt)] = 1.0
        self.cn_share = share


def csr_expand(ptr: np.ndarray, cnt: np.ndarray, sel: np.ndarray):
    """Flat indices covering CSR spans [ptr[s], ptr[s]+cnt[s]) for each s in
    sel, plus the owner row and within-span rank of every flat element."""
    c = cnt[sel].astype(np.int64)
    total = int(c.sum())
    owner = np.repeat(np.arange(len(sel)), c)
    starts = np.concatenate(([0], np.cumsum(c[:-1])))
    rank = np.arange(total, dtype=np.int64) - starts[owner]
    flat = ptr[sel][owner] + rank
    return flat, owner, rank.astype(np.int32)


class WeightAccumulator:
    """Global node k-mer tallies + per-graph kmer totals (the batched
    equivalent of node.KmerFreq updates under minion ownership,
    graphminion.go:67 / graph.go:437-449)."""

    def __init__(self, tables: WindowTables):
        self.t = tables
        self.node_w = np.zeros(tables.num_nodes, dtype=np.float64)
        # per-graph k-mer totals, indexed like tables.graph_ids
        self.graph_kt = np.zeros(len(tables.graph_ids), dtype=np.float64)
        self._w_gidx = np.searchsorted(
            tables.graph_ids, tables.w_graph
        ).astype(np.int32)
        # contiguous views for the native replay
        self._cn_ptr = np.ascontiguousarray(tables.cn_ptr, np.int64)
        self._cn_cnt = np.ascontiguousarray(tables.cn_cnt, np.int32)
        self._cn_grow = np.ascontiguousarray(tables.cn_grow, np.int64)
        self._cn_share = np.ascontiguousarray(tables.cn_share, np.float64)
        self._w_multi = np.ascontiguousarray(tables.w_multi, np.uint8)

    def add_pairs(self, wins: np.ndarray, kc: np.ndarray):
        """Replay increment_subpath for (window, kmer_count) pairs."""
        t = self.t
        import os

        if not os.environ.get("GROOT_NO_NATIVE_CASCADE"):
            from ..io import native

            if native.weight_pairs(
                wins, kc, self._cn_ptr, self._cn_cnt, self._cn_grow,
                self._cn_share, self._w_multi, self._w_gidx,
                self.node_w, self.graph_kt,
            ):
                return
        flat, owner, _rank = csr_expand(t.cn_ptr, t.cn_cnt, wins)
        np.add.at(self.node_w, t.cn_grow[flat], t.cn_share[flat] * kc[owner])
        multi = t.w_multi[wins]
        if multi.any():
            np.add.at(
                self.graph_kt, self._w_gidx[wins[multi]], np.floor(kc[multi])
            )

    def flush(self, store: Dict[int, GrootGraph]):
        nz = np.flatnonzero(self.node_w)
        for row in nz:
            gid, seg = self.t.node_table[row]
            store[int(gid)].get_node(int(seg)).kmer_freq += float(
                self.node_w[row]
            )
        for gi in np.flatnonzero(self.graph_kt):
            store[int(self.t.graph_ids[gi])].kmer_total += float(
                self.graph_kt[gi]
            )
        self.node_w[:] = 0.0
        self.graph_kt[:] = 0.0


def sort_hits(tables: WindowTables, rows: np.ndarray, wins: np.ndarray):
    """Order LSH hits by (read, graph, node, offset); returns the permuted
    (rows, wins) plus combo segmentation (combo = one (read, graph))."""
    order = np.lexsort(
        (tables.w_off[wins], tables.w_node[wins], tables.w_graph[wins], rows)
    )
    rows = rows[order]
    wins = wins[order]
    g = tables.w_graph[wins]
    if len(rows):
        newc = np.empty(len(rows), dtype=bool)
        newc[0] = True
        newc[1:] = (rows[1:] != rows[:-1]) | (g[1:] != g[:-1])
        combo_start = np.flatnonzero(newc)
    else:
        combo_start = np.empty(0, dtype=np.int64)
    return rows, wins, combo_start


def winners(found: np.ndarray, combo_start: np.ndarray):
    """First successful pair per combo segment; returns (winner_idx [C] with
    -1 for none, n_weighted [C]) — the reference weights every mapping it
    tries, stopping after the first success (graphminion.go:60-99)."""
    n = len(found)
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    idx = np.arange(n, dtype=np.int64)
    cand = np.where(found, idx, n)
    first = np.minimum.reduceat(cand, combo_start)
    seg_end = np.append(combo_start[1:], n)
    win = np.where(first < seg_end, first, -1)
    n_weighted = np.where(win >= 0, win + 1 - combo_start, seg_end - combo_start)
    return win, n_weighted
