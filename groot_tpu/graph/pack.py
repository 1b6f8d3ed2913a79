"""Device packing of GrootGraphs: padded traversal matrices.

The reference walks each path one base at a time building transient
(segmentID, offset) arrays (/root/reference/src/graph/graph.go:265-280).
Here those arrays are first-class: per graph we build

  codes    u8  [P, Lmax]   path linear sequences (pad code 4 = N)
  segs     i64 [P, Lmax]   per-base segment ID (pad -1)
  offsets  i32 [P, Lmax]   per-base offset within the segment
  lengths  i32 [P]         ungapped path lengths

which feed the windowed sketching kernel (index) and the alignment
correlator (align). Padding uses code 4 (N, seed 0) — validity is always
masked by `lengths`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..ops.nthash import ASCII_TO_CODE
from .grootgraph import GrootGraph


@dataclass
class PackedPaths:
    graph_id: int
    path_ids: List[int]
    codes: np.ndarray    # u8  [P, Lmax]
    segs: np.ndarray     # i64 [P, Lmax]
    offsets: np.ndarray  # i32 [P, Lmax]
    lengths: np.ndarray  # i32 [P]


def pack_graph_paths(graph: GrootGraph, pad_to: int = 0) -> PackedPaths:
    path_ids = sorted(graph.paths)
    seqs = graph.graph2seqs()
    lengths = np.array([len(seqs[p]) for p in path_ids], dtype=np.int32)
    Lmax = max(pad_to, int(lengths.max()) if len(lengths) else 0)
    P = len(path_ids)
    codes = np.full((P, Lmax), 4, dtype=np.uint8)
    segs = np.full((P, Lmax), -1, dtype=np.int64)
    offsets = np.zeros((P, Lmax), dtype=np.int32)
    for i, pid in enumerate(path_ids):
        codes[i, : lengths[i]] = ASCII_TO_CODE[
            np.frombuffer(seqs[pid], dtype=np.uint8)
        ]
        cursor = 0
        for node in graph.sorted_nodes:
            if pid in node.path_ids:
                n = len(node.sequence)
                segs[i, cursor : cursor + n] = node.segment_id
                offsets[i, cursor : cursor + n] = np.arange(n, dtype=np.int32)
                cursor += n
        if cursor != lengths[i]:
            raise AssertionError("windowing did not traverse entire path")
    return PackedPaths(
        graph_id=graph.graph_id,
        path_ids=path_ids,
        codes=codes,
        segs=segs,
        offsets=offsets,
        lengths=lengths,
    )
