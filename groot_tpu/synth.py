"""Seeded synthetic ARG database and read sets.

Everything the align path needs is generated from one integer seed, so a
run needs no download and no external tree:

* a clustered gene database shaped like arg-annot.90 (the database the
  reference's docs and CI index with ``-w 150 -k 31 -s 20``): 1,055
  clusters, skewed allele counts (most clusters hold 1-3 alleles, a few
  families hold dozens, as bla-TEM and OXA do), gene-length alleles of
  300-3,000 bp with a mean near 900, within-cluster identity of at least
  90% from substitutions plus a few short indels, and about 1% of alleles
  carrying an ``N``. Each cluster is written as a gapped MSA named
  ``cluster-NNNN.msa``;
* 150-bp reads whose names follow the bbmap ``randomreads`` layout that
  ``report.accuracy`` parses (field 2 the position, field 9 the allele):
  a *dense* set sampled from every allele, and a *mix* that plants about
  20 alleles at >= 20x depth in uniform random background.

Run ``python -m groot_tpu.synth OUT_DIR --seed 0`` to write the full-size
set; ``make_dataset`` is the library entry.
"""

from __future__ import annotations

import argparse
import gzip
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
_RC = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _RC[_a] = _b

ARG_ANNOT_90_CLUSTERS = 1055
READ_LEN = 150


@dataclass
class Allele:
    name: str
    cluster: int
    seq: bytes          # ungapped sequence (may hold an N)


@dataclass
class Database:
    msa_dir: str
    alleles: List[Allele]
    clusters: int

    def summary(self) -> Dict[str, float]:
        lens = np.array([len(a.seq) for a in self.alleles])
        n_bases = sum(a.seq.count(b"N") for a in self.alleles)
        return {
            "clusters": self.clusters,
            "alleles": len(self.alleles),
            "path_bases": int(lens.sum()),
            "mean_allele_len": float(lens.mean()),
            "alleles_with_N": sum(b"N" in a.seq for a in self.alleles),
            "path_N_share": n_bases / float(lens.sum()),
        }


@dataclass
class Dataset:
    db: Database
    dense_fastq: str
    mix_fastq: str
    planted: List[str] = field(default_factory=list)
    n_dense: int = 0
    n_mix: int = 0


def _allele_counts(rng, n_clusters: int, n_families: int) -> np.ndarray:
    counts = np.minimum(rng.geometric(0.55, size=n_clusters), 12)
    fam = rng.choice(n_clusters, size=min(n_families, n_clusters),
                     replace=False)
    counts[fam] = rng.integers(24, 90, size=len(fam))
    return counts


def _cluster_msa(rng, cid: int, n_alleles: int, family: bool,
                 n_share: float) -> List[Tuple[str, str]]:
    """One cluster as gapped MSA rows. Alleles are star-derived from a root:
    substitutions at a per-cluster rate (<= 3%, so any two alleles stay
    >= 90% identical), plus at most one short indel each."""
    L = int(np.clip(np.exp(rng.normal(np.log(800.0), 0.45)), 300, 3000))
    root = rng.integers(0, 4, size=L).astype(np.uint8)
    rate = rng.uniform(0.002, 0.006) if family else rng.uniform(0.002, 0.03)
    rows = []                       # per allele: ascii columns [L]
    inserts: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    for j in range(n_alleles):
        seq = root.copy()
        if j:
            sub = rng.random(L) < rate
            seq[sub] = (seq[sub] + rng.integers(1, 4, size=int(sub.sum()))) % 4
        col = BASES[seq].copy()
        if j and rng.random() < 0.3:
            at = int(rng.integers(20, L - 20))
            n = int(rng.integers(1, 7))
            if rng.random() < 0.5:
                col[at : at + n] = ord("-")
            else:
                ins = BASES[rng.integers(0, 4, size=n)]
                inserts.setdefault(at, []).append((j, ins))
        if rng.random() < n_share:
            pos = rng.integers(0, L, size=int(rng.integers(1, 4)))
            col[pos] = np.where(col[pos] == ord("-"), col[pos], ord("N"))
        rows.append(col)
    mat = np.stack(rows)                              # [A, L] ascii
    blocks = []
    prev = 0
    for at in sorted(inserts):
        blocks.append(mat[:, prev : at + 1])
        for j, ins in inserts[at]:
            extra = np.full((n_alleles, len(ins)), ord("-"), np.uint8)
            extra[j] = ins
            blocks.append(extra)
        prev = at + 1
    blocks.append(mat[:, prev:])
    full = np.concatenate(blocks, axis=1)
    out = []
    for j in range(n_alleles):
        row = full[j].tobytes().decode()
        ln = len(row) - row.count("-")
        name = f"argannot~~~(Syn)c{cid:04d}a{j:02d}~~~SYN{cid:04d}.{j}:1-{ln}"
        out.append((name, row))
    return out


def make_database(msa_dir: str, seed: int,
                  n_clusters: int = ARG_ANNOT_90_CLUSTERS,
                  n_families: int = 6, n_share: float = 0.01) -> Database:
    rng = np.random.default_rng([seed, 1])
    os.makedirs(msa_dir, exist_ok=True)
    counts = _allele_counts(rng, n_clusters, n_families)
    fam_cut = 24
    alleles: List[Allele] = []
    for cid in range(n_clusters):
        rows = _cluster_msa(rng, cid, int(counts[cid]),
                            counts[cid] >= fam_cut, n_share)
        with open(os.path.join(msa_dir, f"cluster-{cid:04d}.msa"), "w") as fh:
            for name, row in rows:
                fh.write(f">{name}\n{row}\n")
                alleles.append(
                    Allele(name, cid, row.replace("-", "").encode())
                )
    return Database(msa_dir, alleles, n_clusters)


def _sample_reads(rng, seqs: List[bytes], which: np.ndarray,
                  starts: np.ndarray) -> np.ndarray:
    """u8 [N, READ_LEN] read bytes; path N positions become a random base
    (a sequencer calls a base where the reference holds a wildcard)."""
    buf = np.frombuffer(b"".join(seqs), np.uint8)
    offs = np.concatenate(([0], np.cumsum([len(s) for s in seqs])[:-1]))
    idx = (offs[which] + starts)[:, None] + np.arange(READ_LEN)[None, :]
    reads = buf[idx].copy()
    isn = reads == ord("N")
    reads[isn] = BASES[rng.integers(0, 4, size=int(isn.sum()))]
    return reads


def _write_fastq(path: str, names: List[bytes], reads: np.ndarray,
                 gz: bool) -> None:
    qual = b"I" * reads.shape[1]
    parts = []
    for nm, r in zip(names, reads):
        parts.append(b"@%s\n%s\n+\n%s\n" % (nm, r.tobytes(), qual))
    data = b"".join(parts)
    if gz:
        with gzip.open(path, "wb", compresslevel=1) as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def _names(ids, strand, starts, alleles) -> List[bytes]:
    return [
        b"%d_%s_%d_%d_0_0_0_0_0_%s" % (
            i, b"-" if rc else b"+", s, s + READ_LEN - 1, a.encode()
        )
        for i, rc, s, a in zip(ids, strand, starts, alleles)
    ]


def make_dense_reads(path: str, db: Database, n_reads: int,
                     seed: int) -> None:
    """Error-free reads from every allele (allele uniform, start uniform),
    half of them reverse-complemented: every read maps."""
    rng = np.random.default_rng([seed, 2])
    seqs = [a.seq for a in db.alleles]
    lens = np.array([len(s) for s in seqs])
    which = rng.integers(0, len(seqs), size=n_reads)
    starts = (rng.random(n_reads) * (lens[which] - READ_LEN + 1)).astype(
        np.int64
    )
    reads = _sample_reads(rng, seqs, which, starts)
    rc = np.arange(n_reads) % 2 == 1
    reads[rc] = _RC[reads[rc][:, ::-1]]
    names = _names(range(n_reads), rc, starts,
                   [db.alleles[w].name for w in which])
    _write_fastq(path, names, reads, gz=path.endswith(".gz"))


def make_mix_reads(path: str, db: Database, n_reads: int, seed: int,
                   n_planted: int = 20, arg_share: float = 0.01,
                   max_len: int = 900) -> List[str]:
    """A typical-metagenome mix: ``arg_share`` of the reads come from
    ``n_planted`` alleles (no wildcard, 600 to ``max_len`` bp so the ARG
    share gives each >= 20x depth; a third of them in pairs from one
    cluster, as when a sample carries two variants of a gene, which
    gives the EM shared nodes to split); the rest is uniform
    random background. Each planted allele also gets reads at its start
    and at every second offset of its last 17 window starts: the index
    drops a path's final run of identical window sketches (a reference
    quirk, usually under 13 windows), and these reads keep the allele's
    3' end covered whatever the random starts. Returns the planted allele
    names."""
    rng = np.random.default_rng([seed, 3])
    ok = [
        i for i, a in enumerate(db.alleles)
        if 600 <= len(a.seq) <= max_len and b"N" not in a.seq
    ]
    by_cluster: Dict[int, List[int]] = {}
    for i in rng.permutation(ok):
        by_cluster.setdefault(db.alleles[i].cluster, []).append(int(i))
    clusters = sorted(by_cluster)
    multi = [c for c in clusters if len(by_cluster[c]) >= 2]
    n_pairs = min(len(multi), n_planted // 3)
    pair_cl = set(rng.choice(multi, size=n_pairs, replace=False).tolist())
    singles = [c for c in clusters if c not in pair_cl]
    single_cl = rng.choice(singles, size=n_planted - 2 * n_pairs,
                           replace=False).tolist()
    picks = sorted(
        [i for c in pair_cl for i in by_cluster[c][:2]]
        + [by_cluster[c][0] for c in single_cl]
    )
    seqs = [db.alleles[i].seq for i in picks]
    lens = np.array([len(s) for s in seqs])
    n_arg = int(round(n_reads * arg_share))
    per = np.maximum(np.floor(n_arg * lens / lens.sum()).astype(int), 10)
    per[: max(n_arg - int(per.sum()), 0)] += 1
    which = np.repeat(np.arange(n_planted), per)
    starts = (rng.random(len(which)) * (lens[which] - READ_LEN + 1)).astype(
        np.int64
    )
    first = np.concatenate(([0], np.cumsum(per)[:-1]))
    starts[first] = 0                          # tile both ends
    for j in range(9):
        starts[first + 1 + j] = lens - READ_LEN - 2 * j
    arg = _sample_reads(rng, seqs, which, starts)
    rc = rng.random(len(which)) < 0.5
    arg[rc] = _RC[arg[rc][:, ::-1]]
    n_bg = n_reads - len(which)
    bg = BASES[rng.integers(0, 4, size=(n_bg, READ_LEN))]
    reads = np.concatenate([arg, bg])
    arg_names = _names(range(len(which)), rc, starts,
                       [db.alleles[picks[w]].name for w in which])
    names = arg_names + [b"bg%d" % i for i in range(n_bg)]
    order = rng.permutation(n_reads)
    _write_fastq(path, [names[i] for i in order], reads[order],
                 gz=path.endswith(".gz"))
    return [db.alleles[i].name for i in picks]


def make_dataset(out_dir: str, seed: int,
                 n_clusters: int = ARG_ANNOT_90_CLUSTERS,
                 n_dense: int = 131_072, n_mix: int = 262_144,
                 n_families: int = 6, n_planted: int = 20,
                 n_share: float = 0.01, planted_max_len: int = 900) -> Dataset:
    """Database + dense reads + gzipped mix under ``out_dir``."""
    db = make_database(os.path.join(out_dir, "msa"), seed, n_clusters,
                       n_families, n_share)
    dense = os.path.join(out_dir, "dense.fq")
    mix = os.path.join(out_dir, "mix.fq.gz")
    make_dense_reads(dense, db, n_dense, seed)
    planted = make_mix_reads(mix, db, n_mix, seed, n_planted=n_planted,
                             max_len=planted_max_len)
    return Dataset(db, dense, mix, planted, n_dense, n_mix)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=ARG_ANNOT_90_CLUSTERS)
    args = ap.parse_args(argv)
    ds = make_dataset(args.out_dir, args.seed, n_clusters=args.clusters)
    print(ds.db.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
