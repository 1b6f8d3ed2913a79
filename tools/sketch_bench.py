#!/usr/bin/env python
"""Read-sketch timing: the jnp ntHash sketch on the default JAX device
(ops.nthash.khf_sketch, the GROOT_DEVICE_SKETCH path) against the native
host sketcher (native gio_sketch, the default path), on one batch of
random 150-bp reads at k=31, s=20. Both outputs must agree bit for bit.

Usage: python tools/sketch_bench.py [--reads 32768] [--len 150] [--reps 10]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def best_of(fn, reps):
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--len", type=int, default=150)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from groot_tpu import compile_cache
    from groot_tpu.io import native
    from groot_tpu.ops import nthash

    compile_cache.enable()
    d = jax.devices()[0]
    k, s = 31, 20
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(args.reads, args.len)).astype(np.uint8)
    lens = np.full(args.reads, args.len, np.int32)
    if not native.available():
        print("sketch_bench: the native library is unavailable",
              file=sys.stderr)
        return 1

    ref = native.sketch(codes, lens, k, s)
    hi, lo = nthash.khf_sketch(jnp.asarray(codes), k, s,
                               valid_len=jnp.asarray(lens))
    got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    if not (got == ref).all():
        print("sketch_bench: device and host sketches differ",
              file=sys.stderr)
        return 1

    c_dev = jax.device_put(codes)
    l_dev = jax.device_put(lens)
    t_dev = best_of(
        lambda: jax.block_until_ready(
            nthash.khf_sketch(c_dev, k, s, valid_len=l_dev)
        ),
        args.reps,
    )
    t_dev_io = best_of(
        lambda: np.asarray(
            nthash.khf_sketch(jnp.asarray(codes), k, s,
                              valid_len=jnp.asarray(lens))[0]
        ),
        args.reps,
    )
    t_host = best_of(lambda: native.sketch(codes, lens, k, s), args.reps)
    n = args.reads
    print(f"# {d.platform} {d.device_kind}; batch {n} x {args.len}, "
          f"k={k} s={s}; best of {args.reps}")
    print(f"jnp khf_sketch on device (inputs resident): {t_dev*1e3:9.2f} ms"
          f"  ({n / t_dev:,.0f} reads/s)")
    print(f"jnp khf_sketch with H2D + D2H:             {t_dev_io*1e3:9.2f} ms"
          f"  ({n / t_dev_io:,.0f} reads/s)")
    print(f"native host sketcher ({os.cpu_count()} cores visible):"
          f"       {t_host*1e3:9.2f} ms  ({n / t_host:,.0f} reads/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
