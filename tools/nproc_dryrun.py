#!/usr/bin/env python
"""N-process distributed validation (SURVEY §4: "multi-host = N-process
jax with same seeds; assert tallies equal single-host run").

Each process initializes jax.distributed against a shared coordinator,
contributes its local (virtual CPU) devices to one global mesh, builds the
SAME tiny index from the same seed, and runs the sharded align step
(parallel/device_index.make_sharded_align_step) over a globally sharded
read batch: the index tables are replicated, each process feeds its own
read shard, and the node-weight/graph-kmer tallies are merged with
lax.psum over the global mesh — the DCN-analog merge for a multi-host pod
(PARITY.md §multi-host). Process 0 compares the merged tallies against a
fresh single-process run and writes an OK/FAIL line.

Usage:
  python tools/nproc_dryrun.py                # driver: spawns 2 workers
  python tools/nproc_dryrun.py --worker I N   # internal
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PORT = int(os.environ.get("GROOT_NPROC_PORT", "52763"))
LOCAL_DEVICES = 4


def worker(proc_id: int, num_procs: int, out_path: str) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from __graft_entry__ import _example_batch, _tiny_index
    from groot_tpu.parallel.device_index import (
        DeviceIndex, make_sharded_align_step,
    )

    n_global = num_procs * LOCAL_DEVICES
    assert len(jax.devices()) == n_global, (
        f"expected {n_global} global devices, got {len(jax.devices())}"
    )
    info, index = _tiny_index()  # deterministic: same on every process
    dev = DeviceIndex.build(index, info.store, info.kmer_size, 0.99)
    mesh = Mesh(np.array(jax.devices()).reshape(n_global), ("data",))
    step = make_sharded_align_step(mesh, dev, threshold=0.99)

    B = 8 * n_global
    codes, lengths = _example_batch(info, batch=B, seed=0)
    # global sharding: this process materializes only its own shard
    shard = NamedSharding(mesh, P("data"))
    per = B // num_procs
    lo = proc_id * per

    def make_global(host_arr):
        local = host_arr[lo : lo + per]
        n_local_dev = LOCAL_DEVICES
        rows = per // n_local_dev
        arrs = [
            jax.device_put(
                local[i * rows : (i + 1) * rows], d
            )
            for i, d in enumerate(jax.local_devices())
        ]
        return jax.make_array_from_single_device_arrays(
            host_arr.shape, shard, arrs
        )

    g_codes = make_global(codes)
    g_len = make_global(lengths)
    rep = NamedSharding(mesh, P())
    tree = jax.device_put(dev.tree(), rep)
    win, contain, node_w, graph_k, mapped, dropped = step(
        tree, g_codes, g_len
    )
    nw = np.asarray(node_w.addressable_data(0))
    gk = np.asarray(graph_k.addressable_data(0))

    if proc_id == 0:
        # single-process reference tallies (numpy replay of the same step
        # semantics via the host query + weight accumulator)
        from groot_tpu.align.batch_host import (
            WeightAccumulator, WindowTables, sort_hits,
        )
        from groot_tpu.ops.sketch import sketch_reads, sketch_reads_u64

        tables = WindowTables(index, info.store)
        acc = WeightAccumulator(tables)
        kc = (lengths - info.kmer_size + 1).astype(np.int32)
        u64 = sketch_reads_u64(
            codes, lengths, info.kmer_size, index.sketch_size, None
        )
        if u64 is not None:
            rows, wins = index.query_batch_np(None, None, kc, 0.99, q64=u64)
        else:
            hi, lo_ = sketch_reads(
                codes, lengths, info.kmer_size, index.sketch_size, None
            )
            rows, wins = index.query_batch_np(hi, lo_, kc, 0.99)
        rows, wins, _cs = sort_hits(tables, rows, wins)
        acc.add_pairs(wins, kc[rows].astype(np.float64))
        ok_w = np.allclose(nw, acc.node_w, rtol=1e-5)
        ok_g = np.allclose(gk, acc.graph_kt, rtol=1e-5)
        with open(out_path, "w") as fh:
            if ok_w and ok_g:
                fh.write(
                    f"OK procs={num_procs} devices={n_global} "
                    f"node_mass={nw.sum():.0f} graph_kmers={gk.sum():.0f}\n"
                )
            else:
                fh.write(
                    f"FAIL dw={np.abs(nw-acc.node_w).max()} "
                    f"dg={np.abs(gk-acc.graph_kt).max()}\n"
                )
    jax.distributed.shutdown()
    return 0


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        return worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    num_procs = int(os.environ.get("GROOT_NPROC", "2"))
    out = tempfile.NamedTemporaryFile(
        suffix=".nproc", delete=False
    ).name
    procs = [
        subprocess.Popen(
            [
                sys.executable, os.path.abspath(__file__),
                "--worker", str(i), str(num_procs), out,
            ],
            env={
                **os.environ,
                "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": REPO,
            },
        )
        for i in range(num_procs)
    ]
    rcs = [p.wait(timeout=900) for p in procs]
    line = open(out).read().strip() if os.path.exists(out) else ""
    print(line)
    ok = all(rc == 0 for rc in rcs) and line.startswith("OK")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
