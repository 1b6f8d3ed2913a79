#!/usr/bin/env python
"""Microbenchmark of gather/slice forms on the current backend.

The device cascade (align/device_join.py) is gather-bound, and gather
throughput varies by orders of magnitude with its form. This tool times the
candidate forms on the current backend so the kernel is built on
measurements:

  scalar     x[idx] with idx i32 [N]            (arbitrary single elements)
  rowgather  T[idx] with T [R, W], idx [N]      (whole-row gathers)
  dslice     vmapped lax.dynamic_slice length W (batched contiguous slices)
  taa        take_along_axis within rows        (per-row lane indexing)
  onehot     one-hot matmul substitute          (small tables only)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench(fn, *args, steps=5):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    import numpy as np

    best = float("inf")
    for _ in range(steps):
        t0 = time.time()
        out = fn(*args)
        _ = np.asarray(out).ravel()[0]  # force real completion
        best = min(best, time.time() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from groot_tpu import compile_cache

    compile_cache.enable()
    d = jax.devices()[0]
    print(f"# backend {d.platform} {d.device_kind}", flush=True)

    rng = np.random.default_rng(0)
    F = 4_000_000
    table = jax.device_put(rng.integers(0, 1 << 30, F, dtype=np.int32))

    # scalar gathers
    for n in (1 << 20, 1 << 23):
        idx = jax.device_put(
            rng.integers(0, F, n, dtype=np.int32)
        )
        f = jax.jit(lambda t, i: t[i].sum())
        dt = bench(f, table, idx)
        print(f"scalar gather n={n:>9,}: {dt*1e3:8.1f} ms "
              f"({n/dt/1e6:8.1f} M elem/s)", flush=True)

    # batched dynamic slices, W elements each
    for n, W in ((131_072, 208), ((1 << 20), 16)):
        starts = jax.device_put(
            rng.integers(0, F - W, n, dtype=np.int32)
        )

        @jax.jit
        def f(t, s):
            sl = jax.vmap(
                lambda s0: lax.dynamic_slice(t, (s0,), (W,))
            )(s)
            return sl.sum()

        dt = bench(f, table, starts)
        print(f"dyn-slice n={n:>9,} W={W:>4}: {dt*1e3:8.1f} ms "
              f"({n*W/dt/1e6:8.1f} M elem/s)", flush=True)

    # row gathers from a [R, W] table
    R, W = 25_000, 161
    T2 = jax.device_put(
        rng.integers(0, 1 << 30, (R, W), dtype=np.int32)
    )
    for n in (131_072,):
        idx = jax.device_put(rng.integers(0, R, n, dtype=np.int32))
        f = jax.jit(lambda t, i: t[i].sum())
        dt = bench(f, T2, idx)
        print(f"row gather n={n:>9,} W={W}: {dt*1e3:8.1f} ms "
              f"({n*W/dt/1e6:8.1f} M elem/s)", flush=True)

    # the seed scan's row-gather form (_row_gather) at T1-like widths:
    # full-width rows (the form the kernel uses), random against
    # sequential rows, and a narrower slice of the same table — whether
    # the width or the row count bounds the gather on this backend
    from groot_tpu.align.device_join import _row_gather

    Rb, Wb = 1_500_000, 377
    Tb = jax.device_put(
        rng.integers(0, 1 << 30, (Rb, Wb), dtype=np.int32)
    )
    n = 262_144
    idx_r = jax.device_put(rng.integers(0, Rb, n, dtype=np.int32))
    idx_s = jax.device_put(np.arange(n, dtype=np.int32))
    for name, width, idx in (
        ("full-width random", Wb, idx_r),
        ("full-width sequential", Wb, idx_s),
        ("narrow slice (W-168)", Wb - 168, idx_r),
    ):
        f = jax.jit(
            lambda t, i, w=width: _row_gather(t, i, w)
            .astype(jnp.int32).sum(axis=1).sum()
        )
        dt = bench(f, Tb, idx)
        print(f"rowgather/{name:<22} n={n:,}: {dt*1e3:8.1f} ms "
              f"({dt/n*1e9:6.0f} ns/row)", flush=True)

    # take_along_axis within rows: [N, W] rows, [N, K] lane indices
    N, W2, K = 131_072, 161, 16
    rows = jax.device_put(
        rng.integers(0, 1 << 30, (N, W2), dtype=np.int32)
    )
    li = jax.device_put(
        rng.integers(0, W2, (N, K), dtype=np.int32)
    )
    f = jax.jit(
        lambda r, i: jnp.take_along_axis(r, i, axis=1).sum()
    )
    dt = bench(f, rows, li)
    print(f"taa rows N={N:,} K={K}: {dt*1e3:8.1f} ms "
          f"({N*K/dt/1e6:8.1f} M elem/s)", flush=True)

    # segment_min (stage-2 reduction)
    n, S = 1 << 19, 4096
    seg = jax.device_put(np.sort(rng.integers(0, S, n)).astype(np.int32))
    val = jax.device_put(rng.integers(0, 1 << 30, n, dtype=np.int32))
    f = jax.jit(
        lambda v, s: jax.ops.segment_min(
            v, s, num_segments=S, indices_are_sorted=True
        ).sum()
    )
    dt = bench(f, val, seg)
    print(f"segment_min n={n:,} S={S}: {dt*1e3:8.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
