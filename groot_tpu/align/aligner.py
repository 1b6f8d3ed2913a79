"""Exact graph alignment as a batched match volume (hot loop #4).

Reference: GrootGraph.AlignRead (/root/reference/src/graph/alignment.go) runs
a hierarchical cascade per (read, seed-mapping):

  1. exact alignment with seed offset shuffling 0..MergeSpan+WindowSize
  2. seed-node shuffling over the window's ContainedNodes, offsets 0..10
  3. hard-clip 1 base from the read start (MaxClip=1, alignment.go:16)
  4. hard-clip 1 base from the read end

where "exact alignment" is a recursive DFS over the variation graph matching
the read byte-for-byte ('N' in the graph matches anything), and
processTraversal assigns the path IDs present in EVERY node of a successful
traversal (alignment.go:263-317). The fwd/RC orientation loop wraps the
cascade per mapping (graphminion.go:74-98).

Batched reformulation (no recursion): for the block-structured DAGs groot
builds from MSAs, a DFS traversal whose nodes all belong to path p is exactly
a contiguous segment of p's linear sequence. So alignment against the graph
reduces to exact matching against the padded PATH matrix, and the whole
cascade becomes lookups into a precomputed boolean match volume

    M[r, p, o] = read r matches path p starting at offset o

computed for a whole read batch in ONE cross-correlation (a matmul):

    count[r, p, o] = sum_j onehot5(read)[r, j, :] . onehot5(path)[p, o+j, :]
    M = (count == effective_read_len)

with 5 channels: A,C,G,T,N-in-read; path 'N' and padding are wildcard rows
(all ones) so graph Ns match anything and matches may run past a path's end.
Runs past the end are only kept when the path's terminal node has no
out-edges — the dead-end partial-traversal case of the reference DFS
(alignment.go:229). Three read variants (full, clip-start, clip-end) and both
orientations stack into the kernel dimension, so one conv per (graph, batch)
covers the entire cascade's probe set; match bits ship to the host packed
32-per-u32 and the cascade itself is cheap bit tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.grootgraph import GrootGraph
from ..graph.pack import PackedPaths, pack_graph_paths
from ..io.fastx import FastqRead
from ..ops.nthash import ASCII_TO_CODE, RC_CODE_NP

MAX_CLIP = 1  # alignment.go:16
NODE_SHUFFLES = 10  # alignment.go:52


@dataclass
class AlignmentRecord:
    """One SAM/BAM alignment line (built by AlignRead, alignment.go:113-158)."""

    name: str
    graph_id: int
    path_id: int
    pos: int
    seq: bytes
    qual: bytes
    start_clip: int
    end_clip: int
    reverse: bool
    secondary: bool
    mapq: int = 30


class _GraphPack:
    """Per-graph static arrays for alignment."""

    def __init__(self, graph: GrootGraph):
        packed = pack_graph_paths(graph)
        self.packed = packed
        self.path_ids = packed.path_ids
        self.lengths = packed.lengths
        # node -> per-path start positions and membership
        self.node_pos: Dict[int, Dict[int, int]] = {}
        self.node_len: Dict[int, int] = {}
        for node in graph.sorted_nodes:
            self.node_pos[node.segment_id] = dict(node.position)
            self.node_len[node.segment_id] = len(node.sequence)
        # terminal-node-has-no-out-edges per path (dead-end partial case)
        self.terminal_free: Dict[int, bool] = {}
        for pid in self.path_ids:
            nodes = graph.path_nodes(pid)
            self.terminal_free[pid] = len(nodes[-1].out_edges) == 0 if nodes else False
        # one-hot path matrix with wildcard N/pad rows, built lazily per pad
        self._onehot_cache: Dict[int, np.ndarray] = {}

    def onehot(self, extra_pad: int) -> np.ndarray:
        """[P, Lmax+extra_pad, 5] float32 one-hot with wildcard rows."""
        oh = self._onehot_cache.get(extra_pad)
        if oh is None:
            codes = self.packed.codes
            P, L = codes.shape
            # bucket P (pow2) and L (multiple of 512) so XLA compiles once
            # per bucket across graphs; pad rows/columns are wildcard and
            # never queried by the cascade (it only reads real path rows)
            Pb = max(4, 1 << (P - 1).bit_length())
            Lb = -(-L // 512) * 512 + extra_pad
            padded = np.full((Pb, Lb), 4, dtype=np.uint8)
            padded[:P, :L] = codes
            oh = np.zeros((Pb, Lb, 5), dtype=np.float32)
            for b in range(4):
                oh[:, :, b] = padded == b
            wild = padded == 4  # N in graph or padding: matches anything
            oh[wild] = 1.0
            self._onehot_cache[extra_pad] = oh
        return oh


@partial(jax.jit, static_argnames=())
def _match_bits(path_oh, kernels, eff_len):
    """path_oh [P, Lp, 5] f32; kernels [K, Lr, 5] f32; eff_len [K] i32.
    Returns packed match bits u32 [K, P, ceil(W/32)] where
    W = Lp - Lr + 1 and bit o of word w is match at offset w*32+o."""
    counts = jax.lax.conv_general_dilated(
        path_oh.astype(jnp.bfloat16),
        kernels.astype(jnp.bfloat16),
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NHC", "OHI", "NHC"),
        preferred_element_type=jnp.float32,
    )  # [P, W, K]
    match = counts == eff_len[None, None, :].astype(jnp.float32)
    match = jnp.moveaxis(match, -1, 0)  # [K, P, W]
    K, P, W = match.shape
    W32 = -(-W // 32)
    pad = W32 * 32 - W
    match = jnp.pad(match, ((0, 0), (0, 0), (0, pad)))
    bits = match.reshape(K, P, W32, 32).astype(jnp.uint32) << jnp.arange(
        32, dtype=jnp.uint32
    )
    return bits.sum(axis=-1, dtype=jnp.uint32)


class GraphAligner:
    """Batched exact aligner over all graphs in a store."""

    def __init__(self, store: Dict[int, GrootGraph], references=None):
        self.store = store
        self._packs: Dict[int, _GraphPack] = {}

    def pack(self, graph: GrootGraph) -> _GraphPack:
        gp = self._packs.get(graph.graph_id)
        if gp is None:
            gp = _GraphPack(graph)
            self._packs[graph.graph_id] = gp
        return gp

    # ------------------------------------------------------------------
    def align_read(
        self,
        graph: GrootGraph,
        read: FastqRead,
        mappings: List,
        kmer_count: float,
    ) -> Tuple[List[AlignmentRecord], int]:
        """Single-read convenience wrapper over align_read_batch."""
        out = self.align_read_batch(graph, [(read, mappings, kmer_count)])
        return out[0]

    def align_read_batch(
        self, graph: GrootGraph, items: List[Tuple[FastqRead, List, float]]
    ) -> List[Tuple[List[AlignmentRecord], int]]:
        """graphMinion semantics (graphminion.go:46-102) for a batch of reads
        seeded to one graph: weight then try to align each mapping (fwd then
        RC); the first successful mapping wins and later mappings are neither
        weighted nor aligned.

        One correlation covers every read x orientation x clip-variant;
        the cascade itself is host bit tests."""
        gp = self.pack(graph)
        bits = self._batch_match_bits(gp, [it[0] for it in items])
        out: List[Tuple[List[AlignmentRecord], int]] = []
        for r, (read, mappings, kmer_count) in enumerate(items):
            Lr = len(read.seq)
            records: List[AlignmentRecord] = []
            weighted = 0
            for mapping in mappings:
                graph.increment_subpath(mapping.contained_nodes, kmer_count)
                weighted += 1
                hit = None
                for ori in (0, 1):
                    hit = self._cascade(gp, bits[r], ori, Lr, mapping)
                    if hit is not None:
                        records = self._build_records(graph, read, ori, Lr, hit)
                        break
                if hit is not None:
                    break
            out.append((records, weighted))
        return out

    # ------------------------------------------------------------------
    def _batch_match_bits(self, gp: _GraphPack, reads: List[FastqRead]):
        """Match volumes for a read batch: bits [R, 6, P, W32]; variant rows
        are (fwd|rc) x (full|clip-start|clip-end). Shapes are bucketed
        (reads padded with zero rows, Lr to a multiple of 32, R to a power
        of two) so XLA compiles once per bucket."""
        R = len(reads)
        Lr_max = max(len(r.seq) for r in reads)
        Lr_b = -(-max(Lr_max, 32) // 32) * 32
        R_b = max(1, 1 << (R - 1).bit_length()) if R > 1 else 1
        kernels = np.zeros((R_b * 6, Lr_b, 5), dtype=np.float32)
        eff = np.full(R_b * 6, -1, dtype=np.int32)  # -1 never matches
        for r, read in enumerate(reads):
            codes = ASCII_TO_CODE[np.frombuffer(read.seq, dtype=np.uint8)]
            rc = RC_CODE_NP[codes][::-1]
            Lr = len(codes)
            for o, cs in enumerate((codes, rc)):
                oh = np.zeros((Lr_b, 5), dtype=np.float32)
                oh[np.arange(Lr), cs] = 1.0
                base = r * 6 + o * 3
                kernels[base + 0] = oh
                eff[base + 0] = Lr
                # clip-start: read[1:] aligned at the probe offset
                oh_s = np.zeros_like(oh)
                oh_s[: Lr - 1] = oh[1:Lr]
                kernels[base + 1] = oh_s
                eff[base + 1] = Lr - 1
                # clip-end: drop the last base
                oh_e = oh.copy()
                oh_e[Lr - 1] = 0.0
                kernels[base + 2] = oh_e
                eff[base + 2] = Lr - 1
        path_oh = gp.onehot(extra_pad=Lr_b)
        bits = np.asarray(
            _match_bits(jnp.asarray(path_oh), jnp.asarray(kernels), jnp.asarray(eff))
        )
        P = path_oh.shape[0]
        W32 = bits.shape[-1]
        return bits.reshape(R_b, 6, P, W32)[:R]

    # ------------------------------------------------------------------
    @staticmethod
    def _bit(bits: np.ndarray, variant: int, path_row: int, o: int) -> bool:
        return bool((bits[variant, path_row, o >> 5] >> (o & 31)) & 1)

    def _probe(
        self, gp: _GraphPack, bits, variant: int, eff_len: int, node: int, o_node: int
    ) -> Optional[Dict[int, int]]:
        """Try an exact alignment from `node` at in-node offset `o_node`.
        Returns {path_id: start_pos} for every matching path, or None."""
        if o_node >= gp.node_len.get(node, 0):
            return None  # dfsRecursive offset guard (alignment.go:199-201)
        matches: Dict[int, int] = {}
        pos_map = gp.node_pos.get(node, {})
        for row, pid in enumerate(gp.path_ids):
            if pid not in pos_map:
                continue
            start = pos_map[pid] + o_node
            plen = int(gp.lengths[row])
            if start >= plen:
                continue
            if not self._bit(bits, variant, row, start):
                continue
            if start + eff_len > plen and not gp.terminal_free[pid]:
                # overhang only allowed at a true dead end (alignment.go:229)
                continue
            matches[pid] = start
        return matches or None

    def _cascade(self, gp: _GraphPack, bits, ori: int, Lr: int, mapping):
        """The four-stage hierarchical alignment (alignment.go:34-103).
        Returns (ids->startPos, start_clip, end_clip) or None."""
        v_full = ori * 3 + 0
        v_start = ori * 3 + 1
        v_end = ori * 3 + 2
        seed = mapping.node
        offset = mapping.offset

        # 1. seed offset shuffling
        for shuffle in range(int(mapping.merge_span + mapping.window_size) + 1):
            hit = self._probe(gp, bits, v_full, Lr, seed, offset + shuffle)
            if hit:
                return (hit, 0, 0)
        # 2. seed node shuffling (deterministic ascending-node order where the
        # reference iterates a Go map randomly, SURVEY §7 hard part 3)
        for node in sorted(mapping.contained_nodes):
            for shuffle in range(NODE_SHUFFLES + 1):
                hit = self._probe(gp, bits, v_full, Lr, node, shuffle)
                if hit:
                    return (hit, 0, 0)
        # 3. hard clip read start (MaxClip=1)
        hit = self._probe(gp, bits, v_start, Lr - 1, seed, offset)
        if hit:
            return (hit, 1, 0)
        # 4. hard clip read end
        hit = self._probe(gp, bits, v_end, Lr - 1, seed, offset)
        if hit:
            return (hit, 0, 1)
        return None

    # ------------------------------------------------------------------
    def _build_records(
        self, graph: GrootGraph, read: FastqRead, ori: int, Lr: int, hit
    ) -> List[AlignmentRecord]:
        matches, start_clip, end_clip = hit
        seq = read.seq
        qual = read.qual
        if ori == 1:
            # record carries the reverse-complemented sequence + reversed
            # quals, like RevComplement before the RC attempt (seqio.go:120-133)
            from ..ops.nthash import CODE_TO_ASCII

            codes = ASCII_TO_CODE[np.frombuffer(read.seq, np.uint8)]
            seq = CODE_TO_ASCII[RC_CODE_NP[codes][::-1]].tobytes()
            qual = read.qual[::-1]
        seq_len = Lr - start_clip - end_clip
        aligned = seq[start_clip : start_clip + seq_len]
        aligned_qual = qual[start_clip : start_clip + seq_len] if qual else b""
        records = []
        for i, pid in enumerate(sorted(matches)):
            records.append(
                AlignmentRecord(
                    name=read.id[1:].decode(),
                    graph_id=graph.graph_id,
                    path_id=pid,
                    pos=matches[pid],
                    seq=aligned,
                    qual=aligned_qual,
                    start_clip=start_clip,
                    end_clip=end_clip,
                    reverse=ori == 1,
                    secondary=len(matches) > 1 and i != 0,
                )
            )
        return records
