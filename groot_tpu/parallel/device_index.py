"""Device-resident containment index + fused align step.

This is the multi-chip data plane (SURVEY §2.3): the LSH band tables, window
sketches and window->node weighting coefficients live in device memory as dense arrays
(replicated per device — the full CARD/resfinder indexes are tens of MB);
read batches shard over the mesh's data axis; per-graph k-mer tallies are
scatter-adds into a global node-weight vector merged with a psum — the
batched equivalent of the reference's mutex-guarded counters and
single-writer-per-graph minion discipline (boss.go:28, graphminion.go:67).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.lshe import ContainmentIndex, _mix_bands_jax, MAX_PER_BAND
from ..ops import nthash, u64


@dataclass
class DeviceIndex:
    """Flat arrays for the device align step."""

    k: int
    s: int
    band_k: int
    num_window_kmers: int
    sorted_sigs: jnp.ndarray  # u32 [L, N]
    band_idx: jnp.ndarray     # i32 [L, N]
    fsig_sorted: jnp.ndarray  # u32 [N] sorted full-sketch signatures
    forder: jnp.ndarray       # i32 [N] fsig order -> window id
    cf: int                   # max identical-fsig bucket size
    sk_hi: jnp.ndarray        # u32 [N, s]
    sk_lo: jnp.ndarray        # u32 [N, s]
    graph_ids: jnp.ndarray    # i32 [N]
    win_nodes: jnp.ndarray    # i32 [N, Cn] global node rows (-1 pad)
    win_coeff: jnp.ndarray    # f32 [N, Cn] weight coefficient per node
    win_multi: jnp.ndarray    # bool [N] window spans >1 node
    num_nodes: int
    num_graphs: int
    # host-side lookup: global node row -> (graph_id, segment_id)
    node_table: Optional[np.ndarray] = None  # i64 [num_nodes, 2]

    @classmethod
    def build(
        cls, index: ContainmentIndex, store, kmer_size: int, threshold: float = 0.99
    ) -> "DeviceIndex":
        if index._tables is None:
            index.prepare()
        K = index.optimal_k(index.num_window_kmers, threshold)
        t = index._tables[K]
        # global node numbering over all graphs
        node_row: Dict[Tuple[int, int], int] = {}
        rows: List[Tuple[int, int]] = []
        for gid in sorted(store):
            for node in store[gid].sorted_nodes:
                node_row[(gid, node.segment_id)] = len(rows)
                rows.append((gid, node.segment_id))
        N = index.num_sketches
        soa = getattr(index, "soa", None)
        if soa is not None:
            # vectorized from the v2 struct-of-arrays index
            cn_ptr = soa["cn_ptr"].astype(np.int64)
            cn_cnt = np.diff(cn_ptr)
            Cn = int(cn_cnt.max())
            win_nodes = np.full((N, Cn), -1, dtype=np.int32)
            win_coeff = np.zeros((N, Cn), dtype=np.float32)
            win_multi = cn_cnt > 1
            gid_e = np.repeat(soa["w_graph"], cn_cnt)
            grow_e = np.fromiter(
                (
                    node_row[(int(g), int(s_))]
                    for g, s_ in zip(gid_e, soa["cn_seg"])
                ),
                np.int64,
                len(soa["cn_seg"]),
            )
            node_len_f = np.empty(len(rows), dtype=np.float64)
            for (gid, seg), r in node_row.items():
                node_len_f[r] = store[gid].get_node(seg).segment_length
            lens = node_len_f[grow_e]
            len_sums = np.add.reduceat(lens, cn_ptr[:-1], dtype=np.float64)
            coeff = (lens / np.repeat(len_sums, cn_cnt)) * soa["cn_val"]
            coeff[np.repeat(cn_cnt == 1, cn_cnt)] = 1.0
            owner = np.repeat(np.arange(N), cn_cnt)
            col = np.arange(len(grow_e)) - np.repeat(cn_ptr[:-1], cn_cnt)
            win_nodes[owner, col] = grow_e
            win_coeff[owner, col] = coeff
            w_graph_arr = soa["w_graph"].astype(np.int32)
        else:
            Cn = max(len(k.contained_nodes) for k in index.keys)
            win_nodes = np.full((N, Cn), -1, dtype=np.int32)
            win_coeff = np.zeros((N, Cn), dtype=np.float32)
            win_multi = np.zeros(N, dtype=bool)
            for i, key in enumerate(index.keys):
                graph = store[key.graph_id]
                items = sorted(key.contained_nodes.items())
                if len(items) == 1:
                    nid, _ = items[0]
                    win_nodes[i, 0] = node_row[(key.graph_id, nid)]
                    win_coeff[i, 0] = 1.0  # gets ALL the read's k-mers
                else:
                    win_multi[i] = True
                    total_len = sum(
                        graph.get_node(nid).segment_length for nid, _ in items
                    )
                    for j, (nid, cnt) in enumerate(items):
                        seg_len = graph.get_node(nid).segment_length
                        win_nodes[i, j] = node_row[(key.graph_id, nid)]
                        win_coeff[i, j] = (seg_len / total_len) * cnt
            w_graph_arr = np.array(
                [k.graph_id for k in index.keys], dtype=np.int32
            )
        # full-sketch signature table for the exact all-slot-equality mode
        # (same table the host fast path uses, lshe._build_full_table)
        if not hasattr(index, "_full_table"):
            index._build_full_table()
        fsig, forder = index._full_table
        if len(fsig):
            _, counts = np.unique(fsig, return_counts=True)
            cf = int(counts.max())
        else:
            cf = 1
        return cls(
            k=kmer_size,
            s=index.sketch_size,
            band_k=K,
            num_window_kmers=index.num_window_kmers,
            sorted_sigs=jnp.asarray(t["sorted_sigs"]),
            band_idx=jnp.asarray(t["idx"]),
            fsig_sorted=jnp.asarray(np.ascontiguousarray(fsig, np.uint32)),
            forder=jnp.asarray(forder.astype(np.int32)),
            cf=cf,
            sk_hi=jnp.asarray(
                (index.sketches >> np.uint64(32)).astype(np.uint32)
            ),
            sk_lo=jnp.asarray(
                (index.sketches & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ),
            graph_ids=jnp.asarray(w_graph_arr),
            win_nodes=jnp.asarray(win_nodes),
            win_coeff=jnp.asarray(win_coeff),
            win_multi=jnp.asarray(win_multi),
            num_nodes=len(rows),
            num_graphs=len(store),
            node_table=np.array(rows, dtype=np.int64),
        )

    def tree(self) -> dict:
        """The arrays as a pytree (for shard_map closure-free passing)."""
        return {
            "sorted_sigs": self.sorted_sigs,
            "band_idx": self.band_idx,
            "fsig_sorted": self.fsig_sorted,
            "forder": self.forder,
            "sk_hi": self.sk_hi,
            "sk_lo": self.sk_lo,
            "graph_ids": self.graph_ids,
            "win_nodes": self.win_nodes,
            "win_coeff": self.win_coeff,
            "win_multi": self.win_multi,
        }


def _max_keep_q(d: float, t: float) -> int:
    """Largest integer q with (q+d)/(2q) > t evaluated in float64 — the
    exact containment bound of the host full-equality fast path
    (lshe.query_batch_np); monotonically decreasing in q."""
    if not (1.0 + d) / 2.0 > t:  # q=1 already fails
        return 0
    lo, hi = 1, 1 << 30
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if (mid + d) / (2.0 * mid) > t:
            lo = mid
        else:
            hi = mid - 1
    return lo


def align_step(
    tree: dict,
    codes,            # u8 [B, L]
    lengths,          # i32 [B]
    *,
    k: int,
    s: int,
    band_k: int,
    num_window_kmers: int,
    num_nodes: int,
    num_graphs: int,
    threshold: float,
    full_equality: bool = False,
    cf: int = 1,
    pair_budget: int = 0,
):
    """One fused device step: sketch -> LSH seed -> containment filter ->
    weight scatter (hot loops #2 and #3 plus the weighting).

    The weighting compacts kept (read, window) pairs to `pair_budget` slots
    (default 8*B) before gathering the [pairs, Cn] contained-node rows — a
    dense [B, C, Cn] gather is ~0.5GB per step on the full arg-annot index
    (C=85 candidates, Cn=87 max contained nodes) and dominated step time.
    Kept pairs beyond the budget are counted in the returned `dropped`
    scalar (0 in practice: reads average ~3 hits).

    With full_equality=True (valid whenever the containment bound forces
    all s slots equal for every read in the batch — groot's standard
    t=0.99; decided per batch by make_sharded_align_step exactly like the
    host query), candidates come from an exact join on the full-sketch
    signature table: integer all-slot verification, the containment cutoff
    precomputed in float64 — bit-identical keep decisions to the host
    path, no per-band candidate cap, no f32 boundary loss.

    Returns (win_idx [B, C], contain [B, C], node_weights [num_nodes],
    graph_kmers [num_graphs], mapped [B] bool, dropped i32 scalar)."""
    B, L = codes.shape
    q_hi, q_lo = nthash.khf_sketch(codes, k, s, valid_len=lengths)
    kmer_counts = (lengths - (k - 1)).astype(jnp.int32)

    N = tree["sorted_sigs"].shape[1]
    if full_equality:
        fsig = tree["fsig_sorted"]
        qsig = _mix_bands_jax(q_hi, q_lo, s)[:, 0]
        lo = jnp.searchsorted(fsig, qsig, side="left")
        hi = jnp.searchsorted(fsig, qsig, side="right")
        take = lo[:, None] + jnp.arange(cf)[None, :]
        valid = take < hi[:, None]
        cands = jnp.where(
            valid, tree["forder"][jnp.clip(take, 0, N - 1)], -1
        )
    else:
        sorted_sigs = tree["sorted_sigs"]
        band_idx = tree["band_idx"]
        Lbands = sorted_sigs.shape[0]
        M = MAX_PER_BAND
        sigs = _mix_bands_jax(q_hi, q_lo, band_k)

        def per_band(table_row, idx_row, sig_col):
            lo = jnp.searchsorted(table_row, sig_col, side="left")
            hi = jnp.searchsorted(table_row, sig_col, side="right")
            take = lo[:, None] + jnp.arange(M)[None, :]
            valid = take < hi[:, None]
            take = jnp.clip(take, 0, N - 1)
            return jnp.where(valid, idx_row[take], -1)

        cands = jax.vmap(per_band, in_axes=(0, 0, 1), out_axes=1)(
            sorted_sigs, band_idx, sigs
        ).reshape(B, Lbands * M)
        cands = jnp.sort(cands, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((B, 1), dtype=bool), cands[:, 1:] == cands[:, :-1]],
            axis=1,
        )
        cands = jnp.where(dup, -1, cands)

    safe = jnp.maximum(cands, 0)
    eq = (
        (tree["sk_hi"][safe] == q_hi[:, None, :])
        & (tree["sk_lo"][safe] == q_lo[:, None, :])
    ).sum(-1)
    j = eq.astype(jnp.float32) / s
    qs = kmer_counts[:, None].astype(jnp.float32)
    contain = j * (qs + num_window_kmers) / ((1.0 + j) * qs)
    if full_equality:
        qmax = _max_keep_q(float(num_window_kmers), threshold)
        keep = (cands >= 0) & (eq == s) & (kmer_counts[:, None] <= qmax)
    else:
        keep = (cands >= 0) & (contain > threshold)
    # mesh-padding rows (length 0 -> kmer_counts <= 0) are not reads
    keep = keep & (kmer_counts[:, None] > 0)
    win_idx = jnp.where(keep, cands, -1)

    # weighting (noAlign semantics: every mapping weights its window's nodes,
    # graphminion.go:64-72): compact kept (read, window) pairs to a fixed
    # budget, then scatter coeff * kmer_count into node weights
    C = cands.shape[1]
    P_slots = pair_budget if pair_budget > 0 else 8 * B
    flat_keep = keep.reshape(-1)
    sel = jnp.argsort(~flat_keep)[:P_slots]  # kept slots first
    sel_valid = flat_keep[sel]
    sel_read = sel // C
    sel_win = jnp.where(sel_valid, cands.reshape(-1)[sel], 0)
    n_kept = flat_keep.sum().astype(jnp.int32)
    dropped = jnp.maximum(n_kept - P_slots, 0)

    kc_sel = kmer_counts[sel_read].astype(jnp.float32)       # [P]
    nodes = tree["win_nodes"][sel_win]                       # [P, Cn]
    coeff = tree["win_coeff"][sel_win] * kc_sel[:, None]
    coeff = jnp.where(sel_valid[:, None] & (nodes >= 0), coeff, 0.0)
    node_weights = jnp.zeros(num_nodes, dtype=jnp.float32).at[
        jnp.maximum(nodes, 0).reshape(-1)
    ].add(coeff.reshape(-1))
    # per-graph k-mer totals (multi-node windows only, graph.go:448-449)
    gmask = sel_valid & tree["win_multi"][sel_win]
    graph_kmers = jnp.zeros(num_graphs, dtype=jnp.float32).at[
        jnp.where(sel_valid, tree["graph_ids"][sel_win], 0)
    ].add(jnp.where(gmask, jnp.floor(kc_sel), 0.0))
    mapped = keep.any(axis=1)
    return win_idx, contain, node_weights, graph_kmers, mapped, dropped


def make_sharded_align_step(
    mesh: Mesh, dev: DeviceIndex, threshold: float, axis: str = "data"
):
    """shard_map the align step over the mesh data axis: index replicated,
    reads sharded, tallies merged with a psum across devices."""

    def build(full_eq: bool):
        kwargs = dict(
            k=dev.k,
            s=dev.s,
            band_k=dev.band_k,
            num_window_kmers=dev.num_window_kmers,
            num_nodes=dev.num_nodes,
            num_graphs=dev.num_graphs,
            threshold=threshold,
            full_equality=full_eq,
            cf=dev.cf,
        )

        def local_step(tree, codes, lengths):
            win, con, nw, gk, mapped, dropped = align_step(
                tree, codes, lengths, **kwargs
            )
            # merge tallies across the data axis (allreduce)
            nw = jax.lax.psum(nw, axis)
            gk = jax.lax.psum(gk, axis)
            dropped = jax.lax.psum(dropped, axis)
            return win, con, nw, gk, mapped, dropped

        rep = P()
        shard = P(axis)
        sm = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(rep, shard, shard),
            out_specs=(shard, shard, rep, rep, shard, rep),
        )
        return jax.jit(sm)

    steps: Dict[bool, object] = {}
    d = float(dev.num_window_kmers)
    s = dev.s

    def step(tree, codes, lengths):
        # per-batch mode selection, identical to the host query's
        # full-equality condition (lshe.query_batch_np): when the
        # containment bound forces all s slots equal for every read, the
        # exact join applies; otherwise the banded tables. Mesh padding
        # rows (length 0, pad_batch_for_mesh) are not reads — excluding
        # them keeps a padded final batch in the same mode as unpadded.
        multiproc = False
        try:
            ln = np.asarray(lengths)
        except RuntimeError:
            # multi-process global array: only local shards are
            # addressable. The mode MUST agree across processes (different
            # compiled programs against one global mesh can deadlock if
            # collective usage ever diverges), so the local min k-mer
            # count is globally reduced below before choosing full_eq.
            multiproc = True
            ln = np.concatenate(
                [np.asarray(s.data) for s in lengths.addressable_shards]
            )
        ln = ln[ln > 0]
        kc = ln.astype(np.float64) - (dev.k - 1)
        qmin = float(kc.min()) if kc.size else np.inf
        if multiproc and jax.process_count() > 1:
            from jax.experimental import multihost_utils

            qmin = float(
                multihost_utils.process_allgather(
                    np.float64(qmin), tiled=False
                ).min()
            )
        if not np.isfinite(qmin):
            qmin = 1.0
        bound = s * threshold * qmin / (qmin + d - threshold * qmin)
        full_eq = bool(bound >= s - 1)
        fn = steps.get(full_eq)
        if fn is None:
            fn = steps[full_eq] = build(full_eq)
        return fn(tree, codes, lengths)

    return step
