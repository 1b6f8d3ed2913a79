#!/usr/bin/env python
"""Per-phase profiling of the host align hot path on the bench data
(bench.ensure_data: the seeded arg-annot.90-shaped index and dense reads).

Phases per batch (explicit device syncs so time attributes correctly):
  ingest | sketch | lsh-query | host-sort | cascade-submit (packing) |
  cascade-device | collect (host) | bam
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

CACHE = os.path.join(REPO, ".bench")


def main():
    from bench import ensure_data
    from groot_tpu import compile_cache

    compile_cache.enable()

    from groot_tpu.config import AlignCmd, Info
    from groot_tpu.index.lshe import ContainmentIndex
    from groot_tpu.io import bam as bamio
    from groot_tpu.pipeline.align_pipeline import (
        AlignStats,
        batch_reads_native,
        _pad_batch,
    )
    from groot_tpu.align.batch_host import (
        WeightAccumulator,
        WindowTables,
        sort_hits,
    )
    from groot_tpu.align.hash_join import HashAligner
    from groot_tpu.ops.sketch import sketch_reads

    index_dir, ds = ensure_data(0)
    READS = ds.dense_fastq
    t0 = time.time()
    info = Info.load(os.path.join(index_dir, "groot.gg"))
    info.attach_db(ContainmentIndex.load(os.path.join(index_dir, "groot.lshe")))
    info.containment_threshold = 0.99
    info.sketch = AlignCmd(min_kmer_coverage=1.0)
    print(f"index loaded in {time.time()-t0:.1f}s")

    k, s, t = info.kmer_size, info.sketch_size, info.containment_threshold
    refs = bamio.build_references(info.store)
    t0 = time.time()
    aligner = HashAligner(info.store, refs)
    tables = WindowTables(info.db, info.store)
    acc = WeightAccumulator(tables)
    aligner.attach_tables(tables, info.db, k)
    print(f"aligner setup in {time.time()-t0:.1f}s")
    bam_fh = open(os.path.join(CACHE, "prof.bam"), "wb")
    writer = bamio.BamWriter(bam_fh, refs)
    stats = AlignStats()

    from collections import Counter

    T = Counter()
    batch_size = 4096
    nbatches = 0
    for rep in range(3):
        for batch in batch_reads_native([READS], batch_size):
            nbatches += 1
            t0 = time.time()
            if batch.n < batch_size:
                _pad_batch(batch, batch_size, k)
            hi, lo = sketch_reads(batch.codes, batch.lengths, k, s)
            t1 = time.time()
            kmer_counts = (batch.lengths - k + 1).astype(np.int32)
            rows, wins = info.db.query_batch_np(hi, lo, kmer_counts, t)
            t2 = time.time()
            keep = rows < batch.n_valid
            rows, wins = rows[keep], wins[keep]
            stats.received += batch.n_valid
            rows, wins, combo_start = sort_hits(tables, rows, wins)
            kc_read = kmer_counts.astype(np.float64)
            t3 = time.time()
            aligner.process_batch(
                batch, rows, wins, combo_start, kc_read, acc, writer, stats
            )
            t4 = t5 = t6 = time.time()
            if rep == 0 and nbatches == 1:
                continue  # skip compile batch
            T["sketch"] += t1 - t0
            T["query"] += t2 - t1
            T["sort"] += t3 - t2
            T["align(hash)+bam"] += t4 - t3
            T["n_pairs"] += len(rows)
            T["n_reads"] += batch.n_valid
    writer.close()
    bam_fh.close()
    total = sum(v for k_, v in T.items() if not k_.startswith("n_"))
    print(f"\n=== steady state over {T['n_reads']} reads ===")
    for k_, v in T.items():
        if k_.startswith("n_"):
            print(f"{k_:28s} {v}")
        else:
            print(f"{k_:28s} {v:7.2f}s  {100*v/total:5.1f}%")
    print(f"{'TOTAL':28s} {total:7.2f}s -> {T['n_reads']/total:.0f} reads/s")
    print(f"alignments={stats.alignment_count} mapped={stats.mapped}")


if __name__ == "__main__":
    main()
