"""ntHash: canonical rolling DNA k-mer hashing, vectorised for the device.

Re-implements the hashing used by the reference's sketching layer
(will-rowe/nthash, called from /root/reference/src/minhash/khf.go:38-44 and
kmv.go:41-47) from the published ntHash v1 algorithm (Mohamadi et al. 2016):

  forward  f(i)  = XOR_{j=0..k-1} rol(seed[s[i+j]], k-1-j)
  reverse  r(i)  = XOR_{j=0..k-1} rol(seed[rc(s[i+j])], j)
  canonical c(i) = min(f(i), r(i))
  multihash h_m(i) = c(i) * (m XOR k*MULTISEED);  h ^= h >> MULTISHIFT

Canonicality (identical hashes for a sequence and its reverse complement) is
load-bearing: the RC-pair sketch property test in the reference
(src/minhash/minhash_test.go:139-156) and the fwd/RC alignment attempts
(src/pipeline/graphminion.go:74-76) both rely on it.

Vectorised formulation: instead of the sequential rolling recurrence, we use
the rotate-normalised prefix-XOR identity

  f(i) = rol( X[i+k] ^ X[i], (k-1+i) mod 64 ),  X = prefix-xor of
         t[m] = ror(seed[s[m]], m mod 64)
  r(i) = ror( Y[i+k] ^ Y[i], i mod 64 ),        Y = prefix-xor of
         u[m] = rol(seed[rc(s[m])], m mod 64)

which turns hashing a whole sequence (or a whole batch of reads / graph
traversal matrix) into two parallel XOR scans + element-wise rotates — ideal
for the VPU, O(L) work per lane, no sequential dependency.

A NumPy uint64 golden implementation (`*_np`) is kept for cross-checking.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import u64

# ntHash v1 base seeds (A, C, G, T, N) — published constants
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27

# base codes: A=0 C=1 G=2 T=3 N=4
SEEDS_NP = np.array([SEED_A, SEED_C, SEED_G, SEED_T, SEED_N], dtype=np.uint64)
RC_CODE_NP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N
SEEDS_RC_NP = SEEDS_NP[RC_CODE_NP]

# 256-entry ASCII -> code table (everything non-ACGTacgt becomes N=4),
# mirroring seqio.BaseCheck (/root/reference/src/seqio/seqio.go:72-91)
ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    ASCII_TO_CODE[_b] = _i
    ASCII_TO_CODE[_b + 32] = _i  # lower case

CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


def encode_seq(seq) -> np.ndarray:
    """bytes/str DNA -> uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return ASCII_TO_CODE[np.frombuffer(bytes(seq), dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> bytes:
    return CODE_TO_ASCII[np.asarray(codes, dtype=np.uint8)].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return RC_CODE_NP[codes][::-1]


# ---------------------------------------------------------------------------
# NumPy golden implementation (host / parity checks)
# ---------------------------------------------------------------------------

def _rol_np(x: np.ndarray, r) -> np.ndarray:
    r = np.asarray(r, dtype=np.uint64) % np.uint64(64)
    with np.errstate(over="ignore"):
        return np.where(
            r == 0, x, (x << r) | (x >> (np.uint64(64) - r))
        ).astype(np.uint64)


def canonical_hashes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """All canonical k-mer hashes of a coded sequence. Direct O(L*k) formula."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros((0,), dtype=np.uint64)
    fwd = np.zeros(n, dtype=np.uint64)
    rev = np.zeros(n, dtype=np.uint64)
    seeds = SEEDS_NP[codes]
    seeds_rc = SEEDS_RC_NP[codes]
    for j in range(k):
        fwd ^= _rol_np(seeds[j : j + n], k - 1 - j)
        rev ^= _rol_np(seeds_rc[j : j + n], j)
    return np.minimum(fwd, rev)


def multihash_np(base: np.ndarray, k: int, num: int) -> np.ndarray:
    """ntHash multihash: [n] base hashes -> [n, num] derived hashes."""
    base = np.asarray(base, dtype=np.uint64)
    out = np.empty(base.shape + (num,), dtype=np.uint64)
    out[..., 0] = base
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for m in range(1, num):
            t = base * (np.uint64(m) ^ kseed)
            t ^= t >> np.uint64(MULTISHIFT)
            out[..., m] = t
    return out


_ROTTAB_CACHE: dict = {}


def khf_sketch_np(codes: np.ndarray, k: int, s: int) -> np.ndarray:
    """Golden KHF MinHash sketch (see groot_tpu.ops.minhash for semantics)."""
    c = canonical_hashes_np(codes, k)
    if len(c) == 0:
        raise ValueError(
            f"sequence length ({len(codes)}) is shorter than k-mer size ({k})"
        )
    return multihash_np(c, k, s).min(axis=0)


def khf_sketch_np_batch(
    codes: np.ndarray, valid_len: np.ndarray, k: int, s: int
) -> np.ndarray:
    """Batched host KHF sketching: u8 codes [B, L] (+ per-row valid length)
    -> u64 sketches [B, s]. Same rotate-normalised prefix-XOR formulation as
    the Pallas kernel, with np.bitwise_xor.accumulate as the scan — O(L)
    work per read, no device round trip. Rows shorter than k sketch to
    all-ones (never match anything)."""
    codes = np.asarray(codes, dtype=np.uint8)
    valid_len = np.asarray(valid_len, dtype=np.int64)
    B, L = codes.shape
    FULL = np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        # position-rotated seed tables [5, L], cached per L: one fancy
        # gather replaces two full-width u64 rotate passes
        tabs = _ROTTAB_CACHE.get(L)
        if tabs is None:
            m = (np.arange(L, dtype=np.uint64)) % np.uint64(64)
            tabs = (
                _rol_np(
                    np.broadcast_to(SEEDS_NP[:, None], (5, L)),
                    np.uint64(64) - m[None, :],
                ),
                _rol_np(
                    np.broadcast_to(SEEDS_RC_NP[:, None], (5, L)),
                    m[None, :],
                ),
            )
            _ROTTAB_CACHE[L] = tabs
        pos_idx = np.arange(L)
        t = tabs[0][codes, pos_idx[None, :]]
        u_ = tabs[1][codes, pos_idx[None, :]]
        X = np.bitwise_xor.accumulate(t, axis=1)
        Y = np.bitwise_xor.accumulate(u_, axis=1)
        nk = L - k + 1
        if nk <= 0:
            return np.full((B, s), FULL, dtype=np.uint64)
        # W[i] = X[i+k-1] ^ X[i-1]  (X[-1] = 0)
        wx = X[:, k - 1 :].copy()
        wx[:, 1:] ^= X[:, : nk - 1]
        wy = Y[:, k - 1 :].copy()
        wy[:, 1:] ^= Y[:, : nk - 1]
        lane = np.arange(nk, dtype=np.uint64)
        fwd = _rol_np(wx, (lane + np.uint64(k - 1)) % np.uint64(64))
        rev = _rol_np(
            wy, (np.uint64(64) - (lane % np.uint64(64))) % np.uint64(64)
        )
        c = np.minimum(fwd, rev)
        nk_valid = np.maximum(valid_len - (k - 1), 0)
        invalid = np.arange(nk)[None, :] >= nk_valid[:, None]
        c[invalid] = FULL
        out = np.empty((B, s), dtype=np.uint64)
        out[:, 0] = c.min(axis=1)
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        for slot in range(1, s):
            h = c * (np.uint64(slot) ^ kseed)
            h ^= h >> np.uint64(MULTISHIFT)
            h[invalid] = FULL
            out[:, slot] = h.min(axis=1)
    return out


# ---------------------------------------------------------------------------
# JAX implementation (device)
# ---------------------------------------------------------------------------

def _seed_tables():
    return u64.from_np(SEEDS_NP), u64.from_np(SEEDS_RC_NP)


@partial(jax.jit, static_argnames=("k",))
def canonical_hashes(codes, k: int):
    """Canonical k-mer hashes for coded seq(s); last axis is sequence.

    codes: uint8/int32 [..., L] -> ((hi, lo)) each [..., L-k+1].
    Positions containing padding should be pre-set to code 4 (N, seed 0);
    validity masking is the caller's job.
    """
    codes = codes.astype(jnp.int32)
    L = codes.shape[-1]
    n = L - k + 1
    assert n >= 1, "sequence shorter than k"
    (s_hi, s_lo), (r_hi, r_lo) = _seed_tables()
    seeds = (s_hi[codes], s_lo[codes])
    seeds_rc = (r_hi[codes], r_lo[codes])

    pos = jnp.arange(L, dtype=jnp.uint32)
    t = u64.ror(seeds, pos)        # rol(seed, -m)
    u_ = u64.rol(seeds_rc, pos)    # rol(seed_rc, m)

    def xscan(pair):
        hi = jax.lax.associative_scan(jnp.bitwise_xor, pair[0], axis=-1)
        lo = jax.lax.associative_scan(jnp.bitwise_xor, pair[1], axis=-1)
        return hi, lo

    X = xscan(t)   # inclusive prefix xor
    Y = xscan(u_)

    # window xor: X[i+k-1] ^ X[i-1]  (X[-1] = 0)
    def window_xor(P):
        hi, lo = P
        whi = hi[..., k - 1 :]
        wlo = lo[..., k - 1 :]
        phi = jnp.concatenate(
            [jnp.zeros_like(hi[..., :1]), hi[..., : n - 1]], axis=-1
        )
        plo = jnp.concatenate(
            [jnp.zeros_like(lo[..., :1]), lo[..., : n - 1]], axis=-1
        )
        return (whi ^ phi, wlo ^ plo)

    wx = window_xor(X)
    wy = window_xor(Y)
    i = jnp.arange(n, dtype=jnp.uint32)
    fwd = u64.rol(wx, (i + jnp.uint32(k - 1)) & jnp.uint32(63))
    rev = u64.ror(wy, i & jnp.uint32(63))
    return u64.minimum(fwd, rev)


def multihash_multipliers(k: int, s: int):
    """Host-computed per-slot multipliers (m XOR k*MULTISEED), slot 0 unused."""
    with np.errstate(over="ignore"):
        kseed = np.uint64(np.uint64(k) * np.uint64(MULTISEED))
        mults = np.arange(s, dtype=np.uint64) ^ kseed
    return u64.from_np(mults)


@partial(jax.jit, static_argnames=("k", "s"))
def multihash(base, k: int, s: int):
    """[..., n] canonical hashes -> [..., n, s] multihashes (hi, lo)."""
    m_hi, m_lo = multihash_multipliers(k, s)
    b = (base[0][..., None], base[1][..., None])
    t = u64.mul(b, (m_hi, m_lo))
    t = u64.xor(t, u64.shr(t, MULTISHIFT))
    # slot 0 is the base hash itself
    slot0 = jnp.zeros(t[0].shape[-1], dtype=bool).at[0].set(True)
    return u64.where(slot0, (b[0] + jnp.uint32(0), b[1] + jnp.uint32(0)), t)


@partial(jax.jit, static_argnames=("k", "s"))
def khf_sketch(codes, k: int, s: int, valid_len=None):
    """KHF MinHash sketch of coded sequence(s): [..., L] -> [..., s] (hi, lo).

    valid_len (optional, [...]) masks out k-mers starting at positions
    >= valid_len - k + 1 (for padded batches); masked k-mers contribute
    0xFFFF... (the sketch init value, /root/reference/src/minhash/khf.go:20-23).
    """
    c = canonical_hashes(codes, k)
    n = c[0].shape[-1]
    h = multihash(c, k, s)  # [..., n, s]
    if valid_len is not None:
        # mask AFTER multihash so masked k-mers are maximal in every slot
        nk = jnp.maximum(valid_len - (k - 1), 0)
        mask = (jnp.arange(n) < nk[..., None])[..., None]
        full = jnp.uint32(0xFFFFFFFF)
        h = u64.where(mask, h, (jnp.full_like(h[0], full), jnp.full_like(h[1], full)))
    return u64.min_reduce(h, axis=-2)
