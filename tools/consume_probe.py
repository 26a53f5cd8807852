"""Roofline probe for the consume (scatter) path on the device.

Times, in isolation and at the main bench's shapes:
  1. H2D of a packed read stack
  2. the hash computation alone
  3. the full consume dispatch (hash + 4-table scatter-add)
  4. a sort-aggregate consume variant: one sort of the batch's hash
     stream + segment-sum, then scatter unique buckets once (coverage
     makes ~30x of the k-mer stream redundant, so this trades the
     scatter's conflict handling for a sort)
  5. the fused count+screen dispatch (the bench's program)

Prints one JSON line with per-phase seconds and derived rates, feeding the
BENCH notes (is the consume scatter-bound, and is there sort headroom?).
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from kevlar_tpu.ops import hashing

KSIZE = 31
READLEN = 150
PADLEN = 160
BATCH = 8192
NBATCH = 4
TABLESIZE = 2_000_003
NTABLES = 4


def timeit(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.time() - t0, out


def main():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    starts = rng.integers(0, len(genome) - READLEN, size=BATCH * NBATCH)
    reads = genome[starts[:, None] + np.arange(READLEN)[None, :]]
    stack = np.full((NBATCH, BATCH, PADLEN), 4, np.uint8)
    stack[:, :, :READLEN] = reads.reshape(NBATCH, BATCH, READLEN)

    t0 = time.time()
    dev_stack = jax.device_put(stack)
    jax.block_until_ready(dev_stack)
    h2d_s = time.time() - t0

    @jax.jit
    def hashes_only(stack):
        def body(_, bases):
            h1, h2, valid = hashing.kmer_hashes(bases, KSIZE)
            return 0, (jnp.sum(h1 ^ h2), jnp.sum(valid))
        _, (sums, counts) = jax.lax.scan(body, 0, stack)
        return sums.sum(), counts.sum()

    hash_s, (_, nkmers) = timeit(hashes_only, dev_stack)
    nkmers = int(nkmers)

    @jax.jit
    def consume(tables, stack):
        def body(tables, bases):
            h1, h2, valid = hashing.kmer_hashes(bases, KSIZE)
            h1f, h2f = h1.ravel(), h2.ravel()
            vf = valid.ravel().astype(jnp.int32)
            for t in range(NTABLES):
                idx = ((h1f + jnp.uint32(t) * h2f) %
                       jnp.uint32(TABLESIZE)).astype(jnp.int32)
                tables = tables.at[t, idx].add(vf, mode='drop')
            return tables, None
        tables, _ = jax.lax.scan(body, tables, stack)
        return tables

    tables0 = jnp.zeros((NTABLES, TABLESIZE), jnp.int32)
    consume_s, _ = timeit(consume, tables0, dev_stack)

    @jax.jit
    def consume_sorted(tables, stack):
        def body(tables, bases):
            h1, h2, valid = hashing.kmer_hashes(bases, KSIZE)
            h1f = jnp.where(valid.ravel(), h1.ravel(), jnp.uint32(0))
            h2f = jnp.where(valid.ravel(), h2.ravel(),
                            jnp.uint32(0xFFFFFFFF))
            vf = valid.ravel().astype(jnp.int32)
            # aggregate duplicate k-mers before touching the tables: sort
            # the (h1, h2) stream, segment-sum equal runs, scatter once
            order = jnp.argsort(h1f.astype(jnp.uint64) << jnp.uint64(32) |
                                h2f.astype(jnp.uint64))
            s1, s2, sv = h1f[order], h2f[order], vf[order]
            newrun = jnp.concatenate([
                jnp.ones((1,), bool),
                (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])])
            seg = jnp.cumsum(newrun.astype(jnp.int32)) - 1
            agg = jnp.zeros((s1.shape[0],), jnp.int32).at[seg].add(sv)
            # representative (h1, h2) per run
            rep = jnp.zeros((s1.shape[0],), jnp.uint32)
            rep1 = rep.at[seg].max(s1)
            rep2 = rep.at[seg].max(s2)
            for t in range(NTABLES):
                idx = ((rep1 + jnp.uint32(t) * rep2) %
                       jnp.uint32(TABLESIZE)).astype(jnp.int32)
                tables = tables.at[t, idx].add(agg, mode='drop')
            return tables, None
        tables, _ = jax.lax.scan(body, tables, stack)
        return tables

    sorted_s, _ = timeit(consume_sorted, tables0, dev_stack)

    n_updates = nkmers * NTABLES
    print(json.dumps({
        'metric': 'consume_probe',
        'backend': jax.default_backend(),
        'reads': BATCH * NBATCH,
        'kmers': nkmers,
        'h2d_s': round(h2d_s, 3),
        'hash_s': round(hash_s, 3),
        'consume_s': round(consume_s, 3),
        'consume_sorted_s': round(sorted_s, 3),
        'scatter_updates_per_s': round(n_updates / max(
            consume_s - hash_s, 1e-9) / 1e6, 1),
    }))
    print('# scatter phase {:.3f}s for {:.1f}M updates; sort-aggregate '
          'variant {:.3f}s'.format(consume_s - hash_s, n_updates / 1e6,
                                   sorted_s), file=sys.stderr)


if __name__ == '__main__':
    main()
