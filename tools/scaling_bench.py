#!/usr/bin/env python
"""Weak-scaling measurement of the sharded align step over a virtual mesh.

This measures what virtual CPU devices can show about the sharded step:

  * the fused align step (sketch -> LSH seed -> containment -> weight
    scatter, parallel/device_index.align_step) jitted through shard_map
    over an N-device mesh (index replicated, reads sharded on the data
    axis, tallies psum-merged);
  * weak scaling: per-device batch held constant while N grows, so a
    perfectly scaling step keeps wall time flat (efficiency = t1/tN);
  * the psum payload actually exchanged per step (the only cross-device
    traffic in the design: node weights f32[num_nodes] + graph k-mer
    tallies f32[num_graphs]).

On virtual CPU devices the absolute times are dominated by the host
backend; the quantity of interest is the collective overhead trend and the
measured psum payload (~100KB per multi-thousand-read step), which bounds
the interconnect traffic of the data plane on real cards.

Usage: python tools/scaling_bench.py [--devices 1 2 4 8] [--per-device 512]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    n_max = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_max}"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

    import __graft_entry__ as graft
    from groot_tpu.parallel.device_index import DeviceIndex, make_sharded_align_step
    from groot_tpu.parallel.mesh import make_mesh, pad_batch_for_mesh

    info, index = graft._tiny_index()
    dev = DeviceIndex.build(index, info.store, info.kmer_size, 0.99)
    psum_bytes = 4 * (dev.num_nodes + dev.num_graphs)
    print(
        f"# index: {index.num_sketches} windows, {dev.num_nodes} nodes, "
        f"{dev.num_graphs} graphs; psum payload {psum_bytes} B/step"
    )

    t1 = None
    for n in args.devices:
        mesh = make_mesh(n)
        step = make_sharded_align_step(mesh, dev, threshold=0.99)
        B = args.per_device * n
        codes, lengths = graft._example_batch(info, batch=B)
        codes, lengths, _ = pad_batch_for_mesh(codes, lengths, n)
        tree = dev.tree()
        out = step(tree, codes, lengths)  # compile + warm
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(args.steps):
            t0 = time.time()
            out = step(tree, codes, lengths)
            jax.block_until_ready(out)
            best = min(best, time.time() - t0)
        if t1 is None:
            t1 = best
        eff = t1 / best
        ncores = os.cpu_count() or 1
        floor = min(1.0, ncores / n)
        print(
            f"devices={n:2d} reads/step={B:5d} best step {best*1e3:8.2f} ms "
            f"weak-scaling efficiency {eff:5.2f} "
            f"(host-core time-slicing floor {floor:.2f}: {n} virtual "
            f"devices share {ncores} physical cores)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
