"""64-bit unsigned integer arithmetic as uint32 pairs.

JAX's 64-bit integers need the process-wide x64 flag, which would change the
default dtype of every array in the process. All hash
values in groot_tpu device code are therefore explicit ``(hi, lo)`` pairs of
``uint32`` arrays. This module provides the handful of 64-bit ops the ntHash /
MinHash / LSH pipeline needs: xor, rotate, shift, multiply (mod 2**64),
lexicographic compare / min, and NumPy conversion helpers.

Host-side golden implementations use NumPy uint64 directly (see
groot_tpu.ops.nthash) and are cross-checked against this module in
tests/test_u64.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
MASK16 = np.uint32(0xFFFF)


def make(value) -> tuple:
    """Build a (hi, lo) uint32 scalar pair from a python int / np.uint64."""
    v = int(value) & 0xFFFFFFFFFFFFFFFF
    return (jnp.uint32(v >> 32), jnp.uint32(v & 0xFFFFFFFF))


def from_np(arr: np.ndarray) -> tuple:
    """np.uint64 array -> (hi, lo) uint32 jnp arrays."""
    arr = np.asarray(arr, dtype=np.uint64)
    return (
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def to_np(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 arrays -> np.uint64 array (host)."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def rol(a, r):
    """Rotate left by r (r may be a traced array, any values; taken mod 64)."""
    hi, lo = a
    r = jnp.asarray(r, dtype=U32) & U32(63)
    # if r >= 32, swap halves and rotate by r - 32
    big = r >= U32(32)
    hi, lo = jnp.where(big, lo, hi), jnp.where(big, hi, lo)
    r = jnp.where(big, r - U32(32), r)
    # now 0 <= r < 32; guard the r == 0 case (shift by 32 is undefined in XLA)
    inv = U32(32) - r
    nhi = (hi << r) | _shr_guard(lo, inv)
    nlo = (lo << r) | _shr_guard(hi, inv)
    zero = r == U32(0)
    return (jnp.where(zero, hi, nhi), jnp.where(zero, lo, nlo))


def ror(a, r):
    r = jnp.asarray(r, dtype=U32) & U32(63)
    return rol(a, U32(64) - r)


def _shr_guard(x, s):
    """x >> s where s may be 32 (returns 0 then)."""
    return jnp.where(s >= U32(32), U32(0), x >> jnp.where(s >= U32(32), U32(0), s))


def shr(a, s: int):
    """Logical right shift by a static python int 0 < s < 64."""
    hi, lo = a
    if s == 0:
        return a
    if s < 32:
        return (hi >> U32(s), (lo >> U32(s)) | (hi << U32(32 - s)))
    if s == 32:
        return (jnp.zeros_like(hi), hi)
    return (jnp.zeros_like(hi), hi >> U32(s - 32))


def shl(a, s: int):
    hi, lo = a
    if s == 0:
        return a
    if s < 32:
        return ((hi << U32(s)) | (lo >> U32(32 - s)), lo << U32(s))
    if s == 32:
        return (lo, jnp.zeros_like(lo))
    return (lo << U32(s - 32), jnp.zeros_like(lo))


def _umul32_full(a, b):
    """Full 32x32 -> 64 bit product of uint32 arrays, as (hi, lo) uint32."""
    a0 = a & MASK16
    a1 = a >> U32(16)
    b0 = b & MASK16
    b1 = b >> U32(16)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    carry_mid = (mid < lh).astype(U32)  # wrapped?
    lo = ll + (mid << U32(16))
    carry_lo = (lo < ll).astype(U32)
    hi = hh + (mid >> U32(16)) + (carry_mid << U32(16)) + carry_lo
    return hi, lo


def mul(a, b):
    """(a * b) mod 2**64 for (hi, lo) uint32 pairs."""
    a_hi, a_lo = a
    b_hi, b_lo = b
    p_hi, p_lo = _umul32_full(a_lo, b_lo)
    p_hi = p_hi + a_lo * b_hi + a_hi * b_lo  # wrapping u32 adds
    return (p_hi, p_lo)


def lt(a, b):
    """a < b (unsigned 64-bit lexicographic)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def minimum(a, b):
    take_a = lt(a, b)
    return (jnp.where(take_a, a[0], b[0]), jnp.where(take_a, a[1], b[1]))


def maximum(a, b):
    take_a = lt(a, b)
    return (jnp.where(take_a, b[0], a[0]), jnp.where(take_a, b[1], a[1]))


def min_reduce(a, axis):
    """Min-reduce a (hi, lo) pair along an axis.

    Trick: because the lexicographic (hi, lo) order on uint32 pairs is the
    order of the packed u64, we can reduce in two passes: min hi, then min lo
    over elements whose hi equals the per-slice min.
    """
    hi, lo = a
    mhi = jnp.min(hi, axis=axis, keepdims=True)
    big_lo = jnp.where(hi == mhi, lo, jnp.uint32(0xFFFFFFFF))
    mlo = jnp.min(big_lo, axis=axis, keepdims=True)
    return (jnp.squeeze(mhi, axis=axis), jnp.squeeze(mlo, axis=axis))


def where(pred, a, b):
    return (jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1]))
