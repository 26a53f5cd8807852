"""JAX mirror of the canonical k-mer hashing in :mod:`kevlar_tpu.dna`.

All arithmetic is uint32 (no 64-bit integers on the device).  Must stay op-for-op identical to the numpy implementation;
``tests/test_hashing.py`` cross-checks the two on random sequences.
"""

import numpy as np
import jax.numpy as jnp

GOLDEN1 = jnp.uint32(0x3c6ef372)
GOLDEN2 = jnp.uint32(0x9e3779b9)


def fmix32(h):
    h = h.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85ebca6b)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xc2b2ae35)
    h = h ^ (h >> 16)
    return h


def kmer_codes(bases, ksize):
    """Canonical (hi, lo, valid) code pair per k-window; see dna.kmer_codes."""
    L = bases.shape[-1]
    P = L - ksize + 1
    lo_len = min(ksize, 16)
    hi_len = ksize - lo_len

    b = bases.astype(jnp.uint32)
    comp = jnp.uint32(3) - jnp.minimum(b, 3).astype(jnp.uint32)

    shape = bases.shape[:-1] + (P,)
    f_lo = jnp.zeros(shape, dtype=jnp.uint32)
    f_hi = jnp.zeros(shape, dtype=jnp.uint32)
    r_lo = jnp.zeros(shape, dtype=jnp.uint32)
    r_hi = jnp.zeros(shape, dtype=jnp.uint32)
    if ksize > 32:
        # long-k polynomial path, op-for-op identical to dna.kmer_codes
        # (see the invariant note there; powers shared via dna.POLY_POW*)
        from kevlar_tpu.dna import POLY_POW1, POLY_POW2
        for i in range(ksize):
            w = jnp.asarray(b[..., i:i + P])
            c = jnp.asarray(comp[..., i:i + P])
            f_lo = f_lo + w * jnp.uint32(POLY_POW1[ksize - 1 - i])
            f_hi = f_hi + w * jnp.uint32(POLY_POW2[ksize - 1 - i])
            r_lo = r_lo + c * jnp.uint32(POLY_POW1[i])
            r_hi = r_hi + c * jnp.uint32(POLY_POW2[i])
    else:
        for i in range(ksize):
            w = jnp.asarray(b[..., i:i + P])
            c = jnp.asarray(comp[..., i:i + P])
            if i >= ksize - lo_len:
                f_lo = f_lo + (w << jnp.uint32(2 * (ksize - 1 - i)))
            else:
                f_hi = f_hi + (w << jnp.uint32(2 * (hi_len - 1 - i)))
            if i < lo_len:
                r_lo = r_lo + (c << jnp.uint32(2 * i))
            else:
                r_hi = r_hi + (c << jnp.uint32(2 * (i - lo_len)))

    bad = (bases >= 4).astype(jnp.int32)
    cum = jnp.cumsum(bad, axis=-1)
    cum = jnp.concatenate(
        [jnp.zeros(bases.shape[:-1] + (1,), dtype=jnp.int32), cum], axis=-1)
    valid = (cum[..., ksize:ksize + P] - cum[..., :P]) == 0

    use_f = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    c_hi = jnp.where(use_f, f_hi, r_hi)
    c_lo = jnp.where(use_f, f_lo, r_lo)
    return c_hi, c_lo, valid


def hash_pair(c_hi, c_lo):
    h1 = fmix32(c_lo ^ fmix32(c_hi ^ GOLDEN1))
    h2 = fmix32(c_hi ^ fmix32(c_lo ^ GOLDEN2)) | jnp.uint32(1)
    return h1, h2


def kmer_hashes(bases, ksize):
    c_hi, c_lo, valid = kmer_codes(bases, ksize)
    h1, h2 = hash_pair(c_hi, c_lo)
    return h1, h2, valid


def table_index(h1, h2, table, tablesize):
    """Bucket index for probe `table` via double hashing (uint32 mod)."""
    return (h1 + jnp.uint32(table) * h2) % jnp.uint32(tablesize)


def unpack_bases(packed, badmask, L):
    """Unpack 2-bit base codes + validity bitmask into a [..., L] uint8 array.

    `packed` [..., ceil(L/4)]: 4 bases per byte, base i in bits 2*(i%4).
    `badmask` [..., ceil(L/8)]: numpy packbits layout (bit 7-(i%8) set for
    invalid bases).  The 3.7x smaller wire format pays off wherever
    host->device bandwidth matters (see kevlar_tpu.batch.pack_bases).
    """
    idx = np.arange(L)
    b4 = jnp.repeat(packed, 4, axis=-1)[..., :L]
    shifts = jnp.asarray((2 * (idx % 4)).astype(np.uint8))
    bases = (b4 >> shifts) & jnp.uint8(3)
    b8 = jnp.repeat(badmask, 8, axis=-1)[..., :L]
    bits = jnp.asarray((7 - (idx % 8)).astype(np.uint8))
    bad = (b8 >> bits) & jnp.uint8(1)
    return jnp.where(bad == 1, jnp.uint8(4), bases)
