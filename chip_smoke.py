#!/usr/bin/env python
"""End-to-end smoke check of groot_tpu on one NVIDIA GPU.

Drives `index -> align -> report -> haplotype` through the CLI entry points
(groot_tpu.cli.main) at arg-annot.90 scale on data generated from --seed
(groot_tpu.synth), with the device engine doing the exact alignment, and
checks every phase against the repo's plain references: the host-built
index, the host align engine, and the EM on the CPU and in float64 NumPy.

    python chip_smoke.py            # one GPU, every phase
    python chip_smoke.py --four     # four GPUs: the sharded align only

Each phase prints its result and wall time on its own line; any failed
check exits non-zero. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or without the rest of the repository beside it, the script
exits non-zero before any phase runs.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
INDEX_ARGS = ["-w", "150", "-k", "31", "-s", "20"]

# full size: arg-annot.90's cluster count; reads as in groot_tpu.synth
FULL = dict(n_clusters=1055, n_dense=131_072, n_mix=262_144, n_families=6,
            n_planted=20)

# EM agreement, on per-graph alpha shares (alpha / sum alpha): the same
# float32 program on the CPU, and the float64 NumPy loop (whose convergence
# test may stop an iteration apart: each iteration moves a share < 1%)
EM_TOL_CPU = 1e-4
EM_TOL_F64 = 1e-2
HAP_CUTOFF, HAP_MIN_IT, HAP_MAX_IT = 0.05, 50, 10000  # the CLI defaults


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def say(phase, msg, t0=None):
    wall = f" ({time.time() - t0:.1f}s)" if t0 is not None else ""
    print(f"[{phase}] {msg}{wall}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cli(argv):
    """groot_tpu.cli.main with its standard output captured."""
    from groot_tpu import cli as groot_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = groot_cli.main(argv)
    check(rc == 0, f"groot-tpu {argv[0]} exited {rc}")
    return buf.getvalue()


class AlignProbe:
    """Wraps align_pipeline.run_align so a CLI align run reports which
    engine it resolved to, its aligner, stats, run_align wall time and the
    node weights before pruning."""

    def __init__(self):
        from groot_tpu.pipeline import align_pipeline

        self.mod = align_pipeline
        self.orig = align_pipeline.run_align
        self.last = None

    def __enter__(self):
        import numpy as np

        def wrapped(info, *a, **kw):
            t0 = time.time()
            stats = self.orig(info, *a, **kw)
            dt = time.time() - t0
            rts = getattr(info, "_align_rt", {})
            check(len(rts) == 1, "expected one align runtime")
            (key, aligner, *_rest), = rts.values()
            weights = np.array([
                n.kmer_freq
                for _gid, g in sorted(info.store.items())
                for n in g.sorted_nodes
            ])
            self.last = dict(engine=key[0], aligner=aligner, stats=stats,
                             seconds=dt, weights=weights)
            return stats

        self.mod.run_align = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.run_align = self.orig


def canonical_bam(path):
    from groot_tpu.io import bam as bamio

    refs, recs = bamio.read_bam(path)
    names = {r.ref_id: r.name for r in refs}
    return sorted(
        (r.name, names[r.ref_id], r.pos, r.flag, r.seq_len, tuple(r.cigar))
        for r in recs
    )


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def align_both(phase, work, idx, reads, card):
    """Align `reads` with the device engine (auto) and the host engine;
    the BAM record sets and node weights must agree."""
    import numpy as np

    out = {}
    for engine in ("auto", "hash"):
        t0 = time.time()
        bam = os.path.join(work, f"{phase}-{engine}.bam")
        gdir = os.path.join(work, f"{phase}-{engine}-graphs")
        os.environ["GROOT_ENGINE"] = engine
        try:
            with AlignProbe() as probe:
                cli(["align", "-i", idx, "-f", reads, "--bamOut", bam,
                     "-g", gdir, "--log",
                     os.path.join(work, f"{phase}-{engine}.log")])
        finally:
            os.environ.pop("GROOT_ENGINE", None)
        run = probe.last
        st = run["stats"]
        run.update(bam=bam, graphs=gdir, canon=canonical_bam(bam))
        say(phase, f"engine {engine} -> {run['engine']}: {st.received} reads, "
            f"{st.mapped} mapped, {st.alignment_count} records; "
            f"{st.received / run['seconds']:.0f} reads/s through run_align "
            f"(cold: includes compilation) on {card}", t0)
        out[engine] = run
    dev, host = out["auto"], out["hash"]
    check(dev["engine"] == "device",
          f"auto resolved to {dev['engine']!r}, not the device engine")
    check(host["engine"] == "hash", "GROOT_ENGINE=hash was not honoured")
    check(dev["stats"].mapped == host["stats"].mapped > 0,
          "mapped-read counts differ")
    check(dev["canon"] == host["canon"],
          "device and host BAM record sets differ")
    check(dev["weights"].shape == host["weights"].shape
          and np.allclose(dev["weights"], host["weights"],
                          rtol=1e-6, atol=1e-6),
          "device and host node weights differ")
    al = dev["aligner"]
    say(phase, f"BAM record sets equal ({len(dev['canon'])} records), "
        f"node weights equal ({dev['weights'].size} nodes, rtol 1e-6); "
        f"T1 {al.t1_bytes} bytes; residue combos "
        f"{int(al.stage_times.get('fb_combos', 0))} of "
        f"{int(al.stage_times.get('combos', 0))}")
    return out


def phase_generate(work, seed, sizes):
    from groot_tpu import synth

    t0 = time.time()
    ds = synth.make_dataset(os.path.join(work, "data"), seed, **sizes)
    say("generate", f"seed {seed}: {ds.db.summary()}; dense {ds.n_dense} "
        f"reads, mix {ds.n_mix} reads with {len(ds.planted)} planted "
        "alleles", t0)
    return ds


def phase_index(work, ds):
    import numpy as np

    from groot_tpu.index.lshe import ContainmentIndex

    idx = {}
    for mode in ("host", "device"):
        t0 = time.time()
        path = os.path.join(work, f"index-{mode}")
        if mode == "device":
            os.environ["GROOT_DEVICE_SKETCH"] = "1"
        try:
            cli(["index", "-m", ds.db.msa_dir, "-i", path, *INDEX_ARGS,
                 "--log", os.path.join(work, f"index-{mode}.log")])
        finally:
            os.environ.pop("GROOT_DEVICE_SKETCH", None)
        idx[mode] = path
        say("index", f"{mode}-sketched index built", t0)
    a, b = (ContainmentIndex.load(os.path.join(idx[m], "groot.lshe"))
            for m in ("host", "device"))
    check(a.soa.keys() == b.soa.keys(), "index layouts differ")
    for key in a.soa:
        check(np.array_equal(a.soa[key], b.soa[key]),
              f"device-sketched index differs from host-built in {key}")
    check(a.window_keys == b.window_keys, "index window keys differ")
    say("index", f"device-sketched index bit-identical to host-built "
        f"({a.sketches.shape[0]} sketches x {a.sketches.shape[1]})")
    return idx["host"]


def phase_report(work, runs, planted):
    t0 = time.time()
    tsv = {
        e: cli(["report", "--bamFile", runs[e]["bam"], "-c", "0.97",
                "--log", os.path.join(work, f"report-{e}.log")])
        for e in ("auto", "hash")
    }
    check(tsv["auto"] == tsv["hash"], "report TSVs differ between engines")
    reported = {line.split("\t")[0] for line in tsv["auto"].splitlines()}
    missing = [p for p in planted if p not in reported]
    check(not missing, f"planted alleles missing from the report: {missing}")
    say("report", f"TSVs identical ({len(reported)} ARGs), all "
        f"{len(planted)} planted alleles reported", t0)


def phase_haplotype(work, gdir, planted):
    import jax
    import numpy as np

    from groot_tpu.config import Info
    from groot_tpu.em import em
    from groot_tpu.pipeline.haplotype import load_weighted_gfas

    t0 = time.time()
    gfas = sorted(
        os.path.join(gdir, f) for f in os.listdir(gdir) if f.endswith(".gfa")
    )
    out = os.path.join(work, "haplotypes")
    called_cli = set(cli([
        "haplotype", "-g", gdir, "-o", out, "--cutoff", str(HAP_CUTOFF),
        "--minIterations", str(HAP_MIN_IT), "--maxIterations",
        str(HAP_MAX_IT), "--log", os.path.join(work, "haplotype.log"),
    ]).split())
    check(called_cli, "haplotype called no alleles")
    say("haplotype", f"{len(called_cli)} alleles called from "
        f"{len(gfas)} graphs, {len(called_cli & set(planted))} of the "
        f"{len(planted)} planted", t0)

    t0 = time.time()
    info = Info()
    graphs = load_weighted_gfas(info, gfas)
    for g in graphs:
        g.remove_dead_paths()
    member, counts, n_paths, path_ids = em.em_inputs(graphs)
    mi, ma = HAP_MIN_IT, HAP_MAX_IT
    it_gpu, a_gpu, _ = em._run_em_batched(member, counts, n_paths, mi, ma)
    with jax.default_device(jax.devices("cpu")[0]):
        it_cpu, a_cpu, _ = em._run_em_batched(member, counts, n_paths, mi, ma)
    it_ref, a_ref = em.run_em_batched_np(member, counts, n_paths, mi, ma)

    def shares(a):
        a = np.asarray(a, np.float64)
        return a / np.maximum(a.sum(axis=1, keepdims=True), 1e-300)

    s_gpu, s_cpu, s_ref = shares(a_gpu), shares(a_cpu), shares(a_ref)
    d_cpu = float(np.abs(s_gpu - s_cpu).max())
    d_ref = float(np.abs(s_gpu - s_ref).max())
    total = info.haplotype.total_kmers
    cut = HAP_CUTOFF

    def calls(s):
        return {
            g.paths[pid]
            for gi, g in enumerate(graphs)
            for i, pid in enumerate(path_ids[gi])
            if s[gi, i] * float(g.kmer_total) / float(total) >= cut
        }

    c_gpu, c_cpu, c_ref = calls(s_gpu), calls(s_cpu), calls(s_ref)
    multi = int((np.asarray(n_paths) > 1).sum())
    say("haplotype", f"EM over {len(graphs)} graphs ({multi} with more "
        f"than one path): max share difference "
        f"GPU-CPU {d_cpu:.3g} (tolerance {EM_TOL_CPU}), GPU-float64 "
        f"{d_ref:.3g} (tolerance {EM_TOL_F64}); iterations equal CPU "
        f"{bool((np.asarray(it_gpu) == np.asarray(it_cpu)).all())}, float64 "
        f"{bool((np.asarray(it_gpu) == it_ref).all())}", t0)
    check(d_cpu <= EM_TOL_CPU, "GPU EM differs from the CPU EM")
    check(d_ref <= EM_TOL_F64, "GPU EM differs from the float64 reference")
    check(c_gpu == c_cpu == c_ref, "called alleles differ between EM runs")
    check(c_gpu == called_cli, "CLI calls differ from the GPU EM calls")
    say("haplotype", f"called alleles equal on GPU, CPU and float64 "
        f"({len(c_gpu)})")


def run(work, seed, sizes, four, card):
    import jax

    dev = jax.devices()[0]
    ds = phase_generate(work, seed, sizes)
    if four:
        t0 = time.time()
        idx = os.path.join(work, "index-host")
        cli(["index", "-m", ds.db.msa_dir, "-i", idx, *INDEX_ARGS,
             "--log", os.path.join(work, "index-host.log")])
        say("index", "host-sketched index built", t0)
        runs = align_both("four", work, idx, ds.dense_fastq, card)
        mesh = runs["auto"]["aligner"].mesh
        check(mesh is not None and mesh.devices.size == len(jax.devices()),
              "the device engine did not shard over every card")
        say("four", f"seed scan sharded over {mesh.devices.size} devices "
            f"({mesh.axis_names}); BAM and weights equal the host engine; "
            f"peak_bytes_in_use {peak_bytes(dev)} on device 0")
        return
    idx = phase_index(work, ds)
    align_both("dense", work, idx, ds.dense_fastq, card)
    say("dense", f"peak_bytes_in_use {peak_bytes(dev)}")
    mix = align_both("mix", work, idx, ds.mix_fastq, card)
    say("mix", f"peak_bytes_in_use {peak_bytes(dev)}")
    phase_report(work, mix, ds.planted)
    phase_haplotype(work, mix["auto"]["graphs"], ds.planted)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded align phase")
    args = ap.parse_args(argv)
    t_all = time.time()

    if not os.path.isdir(os.path.join(REPO, "groot_tpu")):
        print("chip_smoke: the groot_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    from groot_tpu import compile_cache
    from groot_tpu.io import native

    card = nvidia_smi()
    print(card, flush=True)
    say("env", f"{devices[0].device_kind} x{len(devices)}, jax "
        f"{jax.__version__}")
    if not native.available():
        print("chip_smoke: the native library did not build or load",
              file=sys.stderr)
        return 1
    say("env", f"native library loaded, deflate: {native.deflate_lib()}; "
        f"compile cache {compile_cache.enable()}")

    work = os.path.join(REPO, ".synth", f"smoke-seed{args.seed}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        run(work, args.seed, FULL, args.four, card.splitlines()[0])
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say("done", "all phases passed", t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
