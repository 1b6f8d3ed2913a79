"""Windowed graph sketching (the index-build hot loop, device side).

Reference: GrootGraph.WindowGraph (/root/reference/src/graph/graph.go:229-396)
slides a w-bp window along every path with stride 1, KHF-sketches each window
(hot loop #1 per SURVEY §3.1), merges runs of consecutive identical sketches
(MergeSpan) and merges identical sketches across paths at the same
node+offset.

Device formulation: one fused device pass per graph computes ALL window
sketches of ALL paths —

  canonical k-mer hashes  (prefix-XOR scan, groot_tpu.ops.nthash)
  -> per-slot multihash    [P, nk, s]
  -> sliding-window min    (van Herk two-pass block min, O(L*s))
  -> sketches              [P, nw, s]  as (hi, lo) uint32

Run detection / key building / cross-path merging are cheap host NumPy
(one-time index build bookkeeping).

Faithful reference quirks reproduced (see test_index.py):
  * the FINAL merge-run of each path is dropped unless it is the only run
    (graph.go:298-338: `sketchSent` is never reset, so the tail run is only
    sent via the `!sketchSent && i == numWindows-1` clause);
  * ContainedNodes counts are per-BASE tallies accumulated over every window
    of the run (graph.go:326-328);
  * cross-path merging only applies at identical (first node, offset) with an
    identical sketch; MergeSpan keeps the max (graph.go:349-388).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.grootgraph import GrootGraph
from ..graph.pack import PackedPaths, pack_graph_paths
from ..ops import nthash, u64


# ---------------------------------------------------------------------------
# Key — the graph-window record (lshe.Key, /root/reference/src/lshe/lshe.go:17-28)
# ---------------------------------------------------------------------------
@dataclass
class Key:
    graph_id: int
    node: int                      # first node in the window
    offset: int                    # offset of the window within that node
    contained_nodes: Dict[int, float]  # nodeID -> per-base tally
    ref: List[int]                 # path IDs containing this window
    sketch: np.ndarray             # uint64 [s]
    merge_span: int = 0
    window_size: int = 0
    freq: float = 0.0
    rc: bool = False


# ---------------------------------------------------------------------------
# device kernel
# ---------------------------------------------------------------------------
def _cummin_pair(pair, reverse: bool = False):
    axis = pair[0].ndim - 1  # associative_scan needs a non-negative axis
    return jax.lax.associative_scan(u64.minimum, pair, axis=axis, reverse=reverse)


@partial(jax.jit, static_argnames=("k", "s", "w"))
def window_sketches(codes, lengths, k: int, s: int, w: int):
    """All stride-1 window sketches of padded path sequences.

    codes: u8 [P, L]; lengths: i32 [P].
    Returns (hi, lo) uint32 [P, nw, s] with nw = L - w + 1; windows past
    lengths[p] - w are garbage (mask on host).
    """
    P, L = codes.shape
    nk_total = L - k + 1        # k-mers per padded row
    m = w - k + 1               # k-mers per window
    nw = L - w + 1

    c = nthash.canonical_hashes(codes, k)          # [P, nk_total]
    h = nthash.multihash(c, k, s)                  # [P, nk_total, s]
    # mask k-mers that start beyond the row's valid length
    nk_valid = jnp.maximum(lengths - (k - 1), 0)
    mask = (jnp.arange(nk_total) < nk_valid[:, None])[..., None]
    FULL = jnp.uint32(0xFFFFFFFF)
    h = u64.where(mask, h, (jnp.full_like(h[0], FULL), jnp.full_like(h[1], FULL)))

    # sliding-window min of length m along axis 1 (van Herk / Gil-Werman)
    # pad to a multiple of m
    n_pad = (-nk_total) % m
    if n_pad:
        pad = [(0, 0), (0, n_pad), (0, 0)]
        full = np.uint32(0xFFFFFFFF)
        h = (
            jnp.pad(h[0], pad, constant_values=full),
            jnp.pad(h[1], pad, constant_values=full),
        )
    n_blocks = (nk_total + n_pad) // m
    blocked = (
        h[0].reshape(P, n_blocks, m, s).swapaxes(-1, -2),
        h[1].reshape(P, n_blocks, m, s).swapaxes(-1, -2),
    )  # [P, nb, s, m] so the scan axis is last
    pref = _cummin_pair(blocked)                   # prefix min within block
    suff = _cummin_pair(blocked, reverse=True)     # suffix min within block
    flat = lambda x: x.swapaxes(-1, -2).reshape(P, n_blocks * m, s)
    pref = (flat(pref[0]), flat(pref[1]))
    suff = (flat(suff[0]), flat(suff[1]))
    idx = jnp.arange(nw)
    out = u64.minimum(
        (suff[0][:, idx, :], suff[1][:, idx, :]),
        (pref[0][:, idx + m - 1, :], pref[1][:, idx + m - 1, :]),
    )
    return out


# ---------------------------------------------------------------------------
# host: merge runs + cross-path merge
# ---------------------------------------------------------------------------
ROW_CHUNK = 512  # path rows per device call (bounds the [R, nk, s] multihash)


@jax.jit
def _change_mask(hi, lo):
    """[P, nw, s] sketches -> [P, nw] bool: window differs from predecessor
    (run starts). Keeps the big sketch volume on device; only run-start
    sketches ever cross to the host."""
    diff = (hi[:, 1:] != hi[:, :-1]).any(-1) | (lo[:, 1:] != lo[:, :-1]).any(-1)
    first = jnp.ones((hi.shape[0], 1), dtype=bool)
    return jnp.concatenate([first, diff], axis=1)


@jax.jit
def _gather_sketches(hi, lo, rows, cols):
    return hi[rows, cols], lo[rows, cols]


def sketch_graphs(
    graphs: List[GrootGraph], window_size: int, kmer_size: int, sketch_size: int
) -> List[Dict[str, List[Key]]]:
    """Dict[key_base -> [Key, ...]] view over sketch_graphs_soa — the
    original WindowGraph-shaped return (tests and small callers); the index
    pipeline consumes the struct-of-arrays directly."""
    soas = sketch_graphs_soa(graphs, window_size, kmer_size, sketch_size)
    return [
        _soa_to_lookup(g, soa, window_size) for g, soa in zip(graphs, soas)
    ]


def sketch_graphs_soa(
    graphs: List[GrootGraph], window_size: int, kmer_size: int, sketch_size: int
) -> List[Dict[str, np.ndarray]]:
    """Batched WindowGraph over many graphs: ALL path rows of all graphs are
    flattened onto one row axis and sketched in fixed-shape device or native
    host calls (the reference sketches graphs one goroutine at a time,
    graph.go:261). Run detection happens in the sketching pass and only the
    distinct (run-start) sketches are kept; returns one merge soa per graph
    (_merge_windows_soa)."""
    packs = [pack_graph_paths(g) for g in graphs]
    for g, packed in zip(graphs, packs):
        if (packed.lengths < window_size).any():
            raise ValueError("graph contains sequence < window size")
        g.num_windows = int((packed.lengths - window_size + 1).sum())
        g.num_distinct_sketches = 0
        g.max_span = 0

    # native host fast path: one C pass over every path row (van Herk
    # sliding-min + run detection); GROOT_DEVICE_SKETCH selects the
    # device kernel instead
    import os

    if not os.environ.get("GROOT_DEVICE_SKETCH"):
        from ..io import native

        all_rows = [
            (gi, pi)
            for gi, packed in enumerate(packs)
            for pi in range(len(packed.path_ids))
        ]
        Lmax = max(
            (int(p.lengths.max()) for p in packs if len(p.lengths)), default=1
        )
        codes = np.full((len(all_rows), Lmax), 4, dtype=np.uint8)
        lens = np.zeros(len(all_rows), dtype=np.int64)
        for r, (gi, pi) in enumerate(all_rows):
            ln = int(packs[gi].lengths[pi])
            codes[r, :ln] = packs[gi].codes[pi, :ln]
            lens[r] = ln
        res = native.window_sketch(codes, lens, kmer_size, sketch_size, window_size)
        if res is not None:
            _rows, cols, sk, row_counts = res
            path_runs: Dict[Tuple[int, int], Tuple[int, np.ndarray, np.ndarray]] = {}
            base = 0
            for r, (gi, pi) in enumerate(all_rows):
                n = int(row_counts[r])
                nw = int(packs[gi].lengths[pi]) - window_size + 1
                path_runs[(gi, pi)] = (
                    nw,
                    cols[base : base + n].astype(np.int64),
                    sk[base : base + n],
                )
                base += n
            out: List[Dict[str, np.ndarray]] = []
            for gi, (graph, packed) in enumerate(zip(graphs, packs)):
                runs = [
                    path_runs[(gi, pi)] for pi in range(len(packed.path_ids))
                ]
                out.append(
                    _merge_windows_soa(graph, packed, runs, window_size)
                )
            return out

    # --- sequence-blocked device sketching -------------------------------
    # Every device call has ONE fixed shape [ROW_CHUNK, BLOCK_NW + w - 1]:
    # rows with more than BLOCK_NW windows split into column blocks carrying
    # a (w-1)-base halo (the sequence-parallel decomposition, SURVEY §5), and
    # block-boundary runs are stitched on the host. One shape = one XLA
    # compile per build; a golden self-check guards that shape.
    path_runs = _device_sketch_blocked(
        packs, window_size, kmer_size, sketch_size
    )

    out: List[Dict[str, np.ndarray]] = []
    for gi, (graph, packed) in enumerate(zip(graphs, packs)):
        runs = [path_runs[(gi, pi)] for pi in range(len(packed.path_ids))]
        out.append(_merge_windows_soa(graph, packed, runs, window_size))
    return out


def sketch_graph(
    graph: GrootGraph, window_size: int, kmer_size: int, sketch_size: int
) -> Dict[str, List[Key]]:
    """WindowGraph equivalent: {"g%dn%do%d" -> [Key, ...]} per graph."""
    return sketch_graphs([graph], window_size, kmer_size, sketch_size)[0]


BLOCK_NW = 1024  # window positions per device column block

_device_check: Dict[Tuple[int, int, int], bool] = {}


def _device_sketch_selfcheck(k: int, s: int, w: int) -> bool:
    """One-time (per shape config) golden check of the blocked device kernel:
    a ragged random [ROW_CHUNK, BLOCK_NW + w - 1] batch, sampled windows
    compared bit-for-bit against the numpy ntHash golden. Corrupt sketches
    would silently lose mapped reads, so the build checks the one shape it
    uses before trusting it."""
    key = (k, s, w)
    ok = _device_check.get(key)
    if ok is not None:
        return ok
    rng = np.random.default_rng(0xC0FFEE)
    W_in = BLOCK_NW + w - 1
    codes = np.full((ROW_CHUNK, W_in), 4, dtype=np.uint8)
    lens = np.zeros(ROW_CHUNK, dtype=np.int32)
    for r in range(0, ROW_CHUNK, 37):  # sparse real rows like a tail chunk
        ln = int(rng.integers(w, W_in + 1))
        lens[r] = ln
        codes[r, :ln] = rng.integers(0, 4, size=ln, dtype=np.uint8)
    lens[0], codes[0, :] = W_in, rng.integers(0, 4, size=W_in, dtype=np.uint8)
    hi, lo = window_sketches(jnp.asarray(codes), jnp.asarray(lens), k, s, w)
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    ok = True
    for r in range(0, ROW_CHUNK, 37):
        nw = lens[r] - w + 1
        if nw <= 0:
            continue
        for i in (0, nw // 2, nw - 1):
            golden = nthash.khf_sketch_np(codes[r, i : i + w], k, s)
            got = (hi[r, i].astype(np.uint64) << np.uint64(32)) | lo[
                r, i
            ].astype(np.uint64)
            if (got != golden).any():
                ok = False
                break
        if not ok:
            break
    _device_check[key] = ok
    return ok


def _device_sketch_blocked(
    packs: List[PackedPaths], window_size: int, kmer_size: int, sketch_size: int
):
    """Fixed-shape blocked device sketching of every path row. Returns
    {(gi, pi): (nw, run_start_cols i64, run_start_sketches u64[M, s])};
    raises if the device kernel fails its golden self-check."""
    if not _device_sketch_selfcheck(kmer_size, sketch_size, window_size):
        raise RuntimeError(
            "device window-sketch kernel failed its golden self-check on "
            f"backend {jax.default_backend()!r} (k={kmer_size}, "
            f"s={sketch_size}, w={window_size}); unset GROOT_DEVICE_SKETCH "
            "to sketch on the host"
        )
    w = window_size
    W_in = BLOCK_NW + w - 1
    # work items: one (row, column-block) tile each
    items: List[Tuple[int, int, int, int]] = []  # (gi, pi, c0, nw_blk)
    for gi, packed in enumerate(packs):
        for pi in range(len(packed.path_ids)):
            nw = int(packed.lengths[pi]) - w + 1
            for c0 in range(0, nw, BLOCK_NW):
                items.append((gi, pi, c0, min(BLOCK_NW, nw - c0)))

    # per-(gi, pi) accumulated (cols, sketches) run lists, in block order
    acc_cols: Dict[Tuple[int, int], List[np.ndarray]] = {}
    acc_sk: Dict[Tuple[int, int], List[np.ndarray]] = {}
    last_sk: Dict[Tuple[int, int], np.ndarray] = {}
    for i0 in range(0, len(items), ROW_CHUNK):
        chunk = items[i0 : i0 + ROW_CHUNK]
        codes = np.full((ROW_CHUNK, W_in), 4, dtype=np.uint8)
        lens = np.zeros(ROW_CHUNK, dtype=np.int32)
        for r, (gi, pi, c0, _nwb) in enumerate(chunk):
            ln = int(packs[gi].lengths[pi])
            span = min(ln - c0, W_in)
            codes[r, :span] = packs[gi].codes[pi, c0 : c0 + span]
            lens[r] = span
        hi, lo = window_sketches(
            jnp.asarray(codes), jnp.asarray(lens), kmer_size,
            sketch_size, w,
        )
        change = np.asarray(_change_mask(hi, lo))  # [R, BLOCK_NW] bool
        g_cols: List[np.ndarray] = []
        rows_l: List[np.ndarray] = []
        for r, (_gi, _pi, _c0, nwb) in enumerate(chunk):
            cols = np.flatnonzero(change[r, :nwb])
            g_cols.append(cols.astype(np.int32))
            rows_l.append(np.full(len(cols), r, dtype=np.int32))
        rows_np = np.concatenate(rows_l)
        cols_np = np.concatenate(g_cols)
        M = len(rows_np)
        Mb = -(-max(M, 1) // 4096) * 4096  # bucket the gather shape
        rpad = np.zeros(Mb, dtype=np.int32)
        cpad = np.zeros(Mb, dtype=np.int32)
        rpad[:M] = rows_np
        cpad[:M] = cols_np
        ghi, glo = _gather_sketches(hi, lo, jnp.asarray(rpad), jnp.asarray(cpad))
        sk = u64.to_np(np.asarray(ghi)[:M], np.asarray(glo)[:M])  # [M, s]
        base = 0
        for r, (gi, pi, c0, _nwb) in enumerate(chunk):
            n = len(g_cols[r])
            cols = g_cols[r].astype(np.int64) + c0
            sks = sk[base : base + n]
            base += n
            key = (gi, pi)
            if c0 > 0 and key in last_sk:
                # stitch across the block boundary: the block's first window
                # is flagged as a run start unconditionally; drop it when it
                # continues the previous block's final run
                if n and (sks[0] == last_sk[key]).all():
                    cols = cols[1:]
                    sks = sks[1:]
            acc_cols.setdefault(key, []).append(cols)
            acc_sk.setdefault(key, []).append(sks)
            if len(sks):
                last_sk[key] = sks[-1]

    path_runs: Dict[Tuple[int, int], Tuple[int, np.ndarray, np.ndarray]] = {}
    for gi, packed in enumerate(packs):
        for pi in range(len(packed.path_ids)):
            nw = int(packed.lengths[pi]) - w + 1
            key = (gi, pi)
            cols = np.concatenate(acc_cols[key])
            sks = (
                np.concatenate(acc_sk[key])
                if acc_sk[key]
                else np.empty((0, sketch_size), np.uint64)
            )
            path_runs[key] = (nw, cols, sks)
    return path_runs


def _merge_windows_soa(
    graph: GrootGraph,
    packed: PackedPaths,
    runs: List[Tuple[int, np.ndarray, np.ndarray]],
    window_size: int,
) -> Dict[str, np.ndarray]:
    """Run merging + cross-path merge, fully vectorized, emitting the
    per-graph struct-of-arrays directly (the per-Key Python objects of the
    old path cost ~60% of the index build; _KeysView materialises Key
    objects lazily when code actually needs one).

    Reference semantics preserved exactly (graph.go:298-388): the tail run
    of a path is dropped unless it is
    the only run; cross-path merging applies at identical (first node,
    offset) with an identical sketch — contained-node tallies add, refs
    append in path order, merge_span keeps the max; distinct sketches at
    the same (node, offset) become separate windows suffixed -0, -1, ... in
    first-occurrence order, and windows emit grouped by (node, offset) in
    first-occurrence order (dict-insertion order of the old lookup)."""
    r_node_l: List[np.ndarray] = []
    r_off_l: List[np.ndarray] = []
    r_span_l: List[np.ndarray] = []
    r_path_l: List[np.ndarray] = []
    r_sk_l: List[np.ndarray] = []
    cn_node_l: List[np.ndarray] = []
    cn_val_l: List[np.ndarray] = []
    cn_cnt_l: List[np.ndarray] = []
    for pi, path_id in enumerate(packed.path_ids):
        nw, run_starts, run_sketches = runs[pi]
        segs = packed.segs[pi]
        run_ends = np.append(run_starts[1:] - 1, nw - 1)

        # reference tail-run behavior: the final run is only emitted when it
        # is the path's only run (graph.go:335-338)
        n_runs = len(run_starts)
        m = n_runs - 1 if n_runs > 1 else n_runs

        a = run_starts[:m].astype(np.int64)
        b = run_ends[:m].astype(np.int64)
        r_node_l.append(segs[a].astype(np.int64))
        r_off_l.append(packed.offsets[pi][a].astype(np.int64))
        r_span_l.append(b - a)
        r_path_l.append(np.full(m, path_id, dtype=np.int64))
        r_sk_l.append(run_sketches[:m])

        # per-base tallies of ALL runs of the path in one pass
        sl = b - a + window_size
        starts = np.concatenate(([0], np.cumsum(sl[:-1])))
        rep = np.repeat(np.arange(m), sl)
        pos = np.arange(int(sl.sum()), dtype=np.int64) - starts[rep] + a[rep]
        wts = (
            np.minimum(pos, b[rep])
            - np.maximum(pos - window_size + 1, a[rep]) + 1
        ).astype(np.float64)
        nodes = segs[pos].astype(np.int64)
        pair = (rep.astype(np.int64) << np.int64(32)) | nodes
        uk, inv = np.unique(pair, return_inverse=True)
        csum = np.bincount(inv, weights=wts)
        cn_node_l.append(uk & np.int64(0xFFFFFFFF))
        cn_val_l.append(csum)
        cn_cnt_l.append(
            np.diff(
                np.searchsorted(
                    (uk >> np.int64(32)).astype(np.int64), np.arange(m + 1)
                )
            ).astype(np.int64)
        )

    if not r_node_l or sum(len(x) for x in r_node_l) == 0:
        raise ValueError(
            f"no sketches produced after windowing graph seqs: {graph.get_ref_ids()}"
        )
    r_node = np.concatenate(r_node_l)
    r_off = np.concatenate(r_off_l)
    r_span = np.concatenate(r_span_l)
    r_path = np.concatenate(r_path_l)
    r_sk = np.concatenate(r_sk_l)
    r_cn_cnt = np.concatenate(cn_cnt_l)
    r_cn_node = np.concatenate(cn_node_l)
    r_cn_val = np.concatenate(cn_val_l)
    M = len(r_node)

    # ---- cross-path grouping -------------------------------------------
    # sketch-groups: identical (node, offset, sketch) merge into one window
    comp = np.empty((M, r_sk.shape[1] + 2), dtype=np.uint64)
    comp[:, 0] = r_node.astype(np.uint64)
    comp[:, 1] = r_off.astype(np.uint64)
    comp[:, 2:] = r_sk
    cv = np.ascontiguousarray(comp).view(
        np.dtype((np.void, comp.dtype.itemsize * comp.shape[1]))
    ).ravel()
    _, g_first, ginv = np.unique(cv, return_index=True, return_inverse=True)
    G = len(g_first)
    # key-base groups: same (node, offset) regardless of sketch
    kb = (r_node << np.int64(32)) | r_off
    _, kb_first, kb_inv = np.unique(kb, return_index=True, return_inverse=True)

    # emission order: key-bases by first occurrence (dict-insertion order),
    # then sketch-groups by first occurrence within the key-base (-i order)
    g_kb_first = kb_first[kb_inv[g_first]]
    order = np.lexsort((g_first, g_kb_first))
    kb_sorted = g_kb_first[order]
    new_kb = np.ones(G, dtype=bool)
    new_kb[1:] = kb_sorted[1:] != kb_sorted[:-1]
    ar = np.arange(G)
    i_idx = ar - np.maximum.accumulate(np.where(new_kb, ar, 0))

    # members of each group, original (= path) order within the group
    mo = np.argsort(ginv, kind="stable")
    counts = np.bincount(ginv, minlength=G).astype(np.int64)
    gptr = np.concatenate(([0], np.cumsum(counts)))
    span_max = np.maximum.reduceat(r_span[mo], gptr[:-1])

    # refs: member path ids per group, in final emission order
    counts_o = counts[order]
    ref_ptr = np.concatenate(([0], np.cumsum(counts_o)))
    g_seq = np.repeat(order, counts_o)
    within = np.arange(int(counts_o.sum()), dtype=np.int64) - np.repeat(
        ref_ptr[:-1], counts_o
    )
    ref_ids = r_path[mo[gptr[g_seq] + within]]

    # contained nodes: sum tallies per (group, node), ascending node
    e_run = np.repeat(np.arange(M), r_cn_cnt)
    e_g = ginv[e_run].astype(np.int64)
    combo = (e_g << np.int64(32)) | r_cn_node
    uc, uinv = np.unique(combo, return_inverse=True)
    uval = np.bincount(uinv, weights=r_cn_val)
    uc_g = (uc >> np.int64(32)).astype(np.int64)
    uc_node = uc & np.int64(0xFFFFFFFF)
    gb = np.searchsorted(uc_g, np.arange(G + 1))
    cn_cnt_g = np.diff(gb).astype(np.int64)
    cn_cnt_o = cn_cnt_g[order]
    cn_ptr = np.concatenate(([0], np.cumsum(cn_cnt_o)))
    g_seq2 = np.repeat(order, cn_cnt_o)
    within2 = np.arange(int(cn_cnt_o.sum()), dtype=np.int64) - np.repeat(
        cn_ptr[:-1], cn_cnt_o
    )
    src2 = gb[g_seq2] + within2
    cn_seg = uc_node[src2]
    cn_val = uval[src2]

    graph.num_distinct_sketches = G
    graph.max_span = int(span_max.max()) if G else 0
    first_o = g_first[order]
    return {
        "w_node": r_node[first_o],
        "w_off": r_off[first_o].astype(np.int32),
        "w_merge_span": span_max[order].astype(np.int32),
        "w_key_i": i_idx.astype(np.int64),
        "sketches": r_sk[first_o].copy(),
        "cn_ptr": cn_ptr,
        "cn_seg": cn_seg,
        "cn_val": cn_val,
        "ref_ptr": ref_ptr,
        "ref_ids": ref_ids,
    }


def _soa_to_lookup(
    graph: GrootGraph, soa: Dict[str, np.ndarray], window_size: int
) -> Dict[str, List[Key]]:
    """Dict[key_base -> [Key, ...]] view over a per-graph merge soa (the
    original sketch_graphs return shape; kept for tests and small callers).
    Key materialisation delegates to lshe._KeysView so the soa->Key field
    mapping lives in exactly one place."""
    from .lshe import _KeysView

    N = len(soa["w_node"])
    full = dict(soa)
    full["w_graph"] = np.full(N, graph.graph_id, dtype=np.int64)
    full["w_window_size"] = np.full(N, window_size, dtype=np.int32)
    view = _KeysView(full)
    lookup: Dict[str, List[Key]] = {}
    for i in range(N):
        key = view[i]
        ks = f"g{key.graph_id}n{key.node}o{key.offset}"
        lookup.setdefault(ks, []).append(key)
    return lookup


