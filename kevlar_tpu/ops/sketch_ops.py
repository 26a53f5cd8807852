"""Jitted device kernels for Count-Min sketch consume / query.

The sketch is a ``uint8 [ntables, tablesize]`` device array.  Each k-mer
increments one bucket per table (double-hashed probes), saturating at
``maxcount`` (255 / 15 / 1 depending on counter width — the same observable
counts as the reference's khmer Counttable / SmallCounttable / Nodetable,
see /root/reference/kevlar/sketch.py and count.py:29-34).

Counting uses a segment-sum (scatter-add of per-batch increments followed by a
saturating merge) so duplicate k-mers inside one batch are counted every time,
matching khmer's consume semantics.
"""

import functools

import jax
import jax.numpy as jnp

from kevlar_tpu.ops import hashing

# counters per byte of device storage (khmer memory parity: 1-bit Nodetables
# pack 8 buckets/byte, 4-bit SmallCounttables 2/byte; bit order LSB-first,
# i.e. bucket i lives in bits [bits*(i % cpb), ...) of byte i // cpb)
COUNTERS_PER_BYTE = {1: 8, 4: 2, 8: 1}


def packed_width(tablesize, counter_bits):
    """Bytes per table row for `tablesize` buckets at `counter_bits`."""
    cpb = COUNTERS_PER_BYTE[counter_bits]
    return -(-int(tablesize) // cpb)


def unpack_counter_row(row, counter_bits, tablesize):
    """uint8 packed row -> uint8 [tablesize] counter values."""
    if counter_bits == 8:
        return row
    if counter_bits == 4:
        out = jnp.stack([row & jnp.uint8(0xF), row >> jnp.uint8(4)],
                        axis=-1).reshape(-1)
    else:
        shifts = jnp.arange(8, dtype=jnp.uint8)
        out = ((row[:, None] >> shifts[None, :]) & jnp.uint8(1)).reshape(-1)
    return out[:tablesize]


def pack_counter_row(row, counter_bits):
    """uint8 [tablesize] counter values -> packed uint8 row."""
    if counter_bits == 8:
        return row
    cpb = COUNTERS_PER_BYTE[counter_bits]
    Z = row.shape[0]
    pad = (-Z) % cpb
    if pad:
        row = jnp.concatenate([row, jnp.zeros((pad,), jnp.uint8)])
    r = row.reshape(-1, cpb).astype(jnp.uint32)
    shifts = jnp.arange(cpb, dtype=jnp.uint32) * jnp.uint32(counter_bits)
    return jnp.sum(r << shifts[None, :], axis=1).astype(jnp.uint8)


def gather_counts(tables, h1, h2, counter_bits=8, tablesize=None):
    """Min-over-tables count for each (h1, h2) hash pair. Any shape.

    ``tables`` is the (possibly bit-packed) uint8 device array; for
    sub-byte counters pass the true ``tablesize`` (bucket count).
    """
    ntables = tables.shape[0]
    if counter_bits == 8:
        tablesize = tables.shape[1]
    counts = None
    for t in range(ntables):
        idx = hashing.table_index(h1, h2, t, tablesize).astype(jnp.int32)
        if counter_bits == 8:
            c = tables[t][idx]
        elif counter_bits == 4:
            byte = tables[t][idx >> 1]
            c = (byte >> ((idx & 1) << 2).astype(jnp.uint8)) & jnp.uint8(0xF)
        else:
            byte = tables[t][idx >> 3]
            c = (byte >> (idx & 7).astype(jnp.uint8)) & jnp.uint8(1)
        counts = c if counts is None else jnp.minimum(counts, c)
    return counts


def pack_sample_tables(tables_list):
    """Interleave S samples' uint8 tables into ceil(S/4) uint32 word arrays.

    All tables must share the same ``[ntables, tablesize]`` shape.  Word
    array w holds samples ``4w .. 4w+3``: byte ``s % 4`` of
    ``packed[w][t, i]`` is sample s's counter at bucket ``(t, i)``.  Because
    the double-hashed bucket index depends only on (h1, h2, t) — never on
    the sample — one uint32 gather then serves up to four samples' counts,
    cutting the novel screen's random-access traffic (the hot loop of
    reference novel.py:95-176) from S*ntables byte-gathers to
    ceil(S/4)*ntables word-gathers.
    """
    words = []
    for w in range(0, len(tables_list), 4):
        acc = tables_list[w].astype(jnp.uint32)
        for s, tbl in enumerate(tables_list[w + 1:w + 4], start=1):
            acc = acc | (tbl.astype(jnp.uint32) << jnp.uint32(8 * s))
        words.append(acc)
    return tuple(words)


def gather_counts_multi(packed_words, nsamples, h1, h2):
    """Min-over-tables counts for every sample at once: uint8 [S, ...].

    ``packed_words`` comes from :func:`pack_sample_tables`.  Gathers one
    uint32 per (word, table) probe and splits out the bytes.
    """
    per_sample = [None] * nsamples
    for w, packed in enumerate(packed_words):
        ntables, tablesize = packed.shape
        gathered = None
        for t in range(ntables):
            idx = hashing.table_index(h1, h2, t, tablesize)
            word = packed[t][idx.astype(jnp.int32)]
            if gathered is None:
                gathered = word[None]
            else:
                gathered = jnp.concatenate([gathered, word[None]])
        # gathered: uint32 [ntables, ...]; byte s is sample 4w+s's count
        for s in range(4 * w, min(4 * w + 4, nsamples)):
            byte = (gathered >> jnp.uint32(8 * (s % 4))) & jnp.uint32(0xFF)
            per_sample[s] = jnp.min(byte, axis=0).astype(jnp.uint8)
    return jnp.stack(per_sample)


def _apply_mask_screen(mask_tables, h1, h2, valid, threshold, consume_masked,
                       mask_bits=8, mask_tablesize=None):
    mcnt = gather_counts(mask_tables, h1, h2, counter_bits=mask_bits,
                         tablesize=mask_tablesize)
    if consume_masked:
        return valid & (mcnt >= jnp.uint8(threshold))
    return valid & (mcnt <= jnp.uint8(threshold))


def planar_index(idx, counter_bits, nbytes):
    """Bucket index -> position in the PLANAR unpacked row.

    LAYOUT CONTRACT (shared with :mod:`kevlar_tpu.parallel.sharded`, which
    routes increments into the same planar temporaries): sub-byte unpacked
    temporaries are kept plane-major — all the low nibbles/bits of the row,
    then all the high ones: planar position
    ``(idx % cpb) * nbytes + idx // cpb``, where ``nbytes`` is the packed
    row width (:func:`packed_width`).  A bucket-ordered unpack would
    materialise a [nbytes, cpb] intermediate with a tiny minor dimension,
    which a tiled device layout may pad many times over; the planar form
    is flat 1-D, and the index remap is a bijection so counts are
    identical.  Any change here must change :func:`unpack_row_planar` /
    :func:`pack_row_planar` in lockstep.
    """
    if counter_bits == 8:
        return idx
    if counter_bits == 4:
        return (idx & 1) * nbytes + (idx >> 1)
    return (idx & 7) * nbytes + (idx >> 3)


def unpack_row_planar(row, counter_bits):
    """Packed uint8 [nbytes] row -> flat PLANAR uint8 [cpb*nbytes] row
    (plane-major order, the :func:`planar_index` layout contract)."""
    if counter_bits == 8:
        return row
    if counter_bits == 4:
        return jnp.concatenate([row & jnp.uint8(0xF), row >> jnp.uint8(4)])
    return jnp.concatenate([(row >> jnp.uint8(s)) & jnp.uint8(1)
                            for s in range(8)])


def pack_row_planar(planar, counter_bits):
    """Flat PLANAR uint8 [cpb*nbytes] row -> packed uint8 [nbytes] row
    (inverse of :func:`unpack_row_planar`)."""
    if counter_bits == 8:
        return planar
    cpb = COUNTERS_PER_BYTE[counter_bits]
    nbytes = planar.shape[0] // cpb
    planes = [planar[p * nbytes:(p + 1) * nbytes].astype(jnp.uint32)
              for p in range(cpb)]
    acc = planes[0]
    for p in range(1, cpb):
        acc = acc | (planes[p] << jnp.uint32(p * counter_bits))
    return acc.astype(jnp.uint8)


# the planar layout is a cross-module contract (parallel/sharded.py routes
# into it); the public names above are canonical, these aliases remain for
# in-module brevity
_planar_index = planar_index
_unpack_row_planar = unpack_row_planar
_pack_row_planar = pack_row_planar


def _unpack_tables_i32(tables, counter_bits):
    """Packed uint8 tables -> int32 [ntables, cpb*nbytes] PLANAR accumulator.

    NOTE the accumulator length is ``cpb * nbytes`` (plane-major planar
    positions, :func:`planar_index`), NOT ``tablesize`` — for 8-bit they
    coincide; for sub-byte counters callers must address it through
    :func:`planar_index` only.
    """
    rows = [unpack_row_planar(tables[t], counter_bits)
            for t in range(tables.shape[0])]
    return jnp.stack(rows).astype(jnp.int32)


def _pack_tables_i32(acc, maxcount, counter_bits):
    """Saturate a PLANAR int32 accumulator (:func:`_unpack_tables_i32`
    layout) and repack to the persistent layout."""
    sat = jnp.minimum(acc, maxcount).astype(jnp.uint8)
    return jnp.stack([pack_row_planar(sat[t], counter_bits)
                      for t in range(sat.shape[0])])


def _scatter_hashes_i32(acc, h1, h2, valid, tablesize, counter_bits=8):
    """Scatter-add valid hashes into the PLANAR int32 accumulator, in place.

    Inside a lax.scan the carried buffer is updated without materialising
    an O(tablesize) temporary per batch — the saturating min happens once
    per stack (identical counts: min-at-end equals per-increment
    saturation for monotone adds).
    """
    h1f = h1.ravel()
    h2f = h2.ravel()
    vf = valid.ravel()
    ntables = acc.shape[0]
    nbytes = packed_width(tablesize, counter_bits)
    planar_size = COUNTERS_PER_BYTE[counter_bits] * nbytes
    for t in range(ntables):
        idx = hashing.table_index(h1f, h2f, t, tablesize).astype(jnp.int32)
        idx = _planar_index(idx, counter_bits, nbytes)
        # invalid/masked k-mers go OUT OF BOUNDS and are dropped by the
        # scatter instead of adding 0: identical counts, and no write
        idx = jnp.where(vf, idx, planar_size)
        acc = acc.at[t, idx].add(1, mode='drop')
    return acc


def _consume_hashes(tables, h1, h2, valid, maxcount, counter_bits=8,
                    tablesize=None):
    """Saturating-add each valid hash into every table; returns new tables.

    For sub-byte counters the persistent row stays bit-packed (khmer memory
    parity); it is unpacked PLANAR, updated, and repacked per batch —
    elementwise work plus the planar index remap (see
    :func:`_planar_index`).
    """
    ntables = tables.shape[0]
    if counter_bits == 8:
        tablesize = tables.shape[1]
    nbytes = packed_width(tablesize, counter_bits)
    planar_size = COUNTERS_PER_BYTE[counter_bits] * nbytes
    h1f = h1.ravel()
    h2f = h2.ravel()
    vf = valid.ravel()
    new_rows = []
    for t in range(ntables):
        idx = hashing.table_index(h1f, h2f, t, tablesize).astype(jnp.int32)
        idx = _planar_index(idx, counter_bits, nbytes)
        # invalid/masked k-mers scatter out of bounds (mode='drop') rather
        # than adding 0: identical counts, and no write
        idx = jnp.where(vf, idx, planar_size)
        inc = jnp.zeros((planar_size,), dtype=jnp.int32).at[idx].add(
            1, mode='drop')
        row = _unpack_row_planar(tables[t], counter_bits)
        row = jnp.minimum(row.astype(jnp.int32) + inc,
                          maxcount).astype(jnp.uint8)
        new_rows.append(_pack_row_planar(row, counter_bits))
    return jnp.stack(new_rows)


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'maxcount', 'numbands', 'mask_threshold',
                     'consume_masked', 'has_mask', 'counter_bits', 'tablesize',
                     'mask_bits', 'mask_tablesize'),
    donate_argnames=('tables',))
def consume_batch(tables, bases, ksize, maxcount, numbands=None, band=None,
                  mask_tables=None, has_mask=False, mask_threshold=0,
                  consume_masked=False, counter_bits=8, tablesize=None,
                  mask_bits=8, mask_tablesize=None):
    """Count every k-mer of a padded read batch into the sketch.

    Returns (new_tables, n_kmers_consumed).  Banding keeps only k-mers whose
    primary hash falls in the band: ``h1 & (numbands-1) == band`` (power-of-two
    bands, the same hash-space sharding semantics as the reference's
    ``consume_seqfile_banding`` / docs/banding.rst).  Masking keeps k-mers
    absent from (or, with ``consume_masked``, present in) a mask sketch
    (count.py:42-71 semantics).
    """
    h1, h2, valid = hashing.kmer_hashes(bases, ksize)
    if numbands:
        valid = valid & ((h1 & jnp.uint32(numbands - 1)) == jnp.uint32(band))
    if has_mask:
        valid = _apply_mask_screen(mask_tables, h1, h2, valid,
                                   mask_threshold, consume_masked,
                                   mask_bits, mask_tablesize)
    new_tables = _consume_hashes(tables, h1, h2, valid, maxcount,
                                 counter_bits, tablesize)
    return new_tables, jnp.sum(valid.astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'maxcount', 'numbands',
                     'mask_threshold', 'consume_masked', 'has_mask',
                     'counter_bits', 'tablesize', 'mask_bits',
                     'mask_tablesize'),
    donate_argnames=('tables',))
def consume_batch_stack(tables, bases_stack, ksize, maxcount, numbands=None,
                        band=None, mask_tables=None, has_mask=False,
                        mask_threshold=0, consume_masked=False,
                        counter_bits=8, tablesize=None, mask_bits=8,
                        mask_tablesize=None):
    """Count a [NB, B, L] stack of read batches in ONE device dispatch.

    Scans over the leading axis with an int32 accumulator (4x the packed
    table bytes) that saturates once per stack — identical counts to
    per-batch saturation (min-at-end equals per-increment saturation for
    monotone adds), and one O(tablesize) pass per stack instead of one per
    batch: 4.9x faster than per-batch saturation at the helium sample
    table on an H100 (docs/performance.md), and the strategy the CPU
    backend already used.
    """
    if counter_bits == 8:
        tablesize = tables.shape[1]

    def body(acc, bases):
        h1, h2, valid = hashing.kmer_hashes(bases, ksize)
        if numbands:
            valid = valid & ((h1 & jnp.uint32(numbands - 1))
                             == jnp.uint32(band))
        if has_mask:
            valid = _apply_mask_screen(mask_tables, h1, h2, valid,
                                       mask_threshold, consume_masked,
                                       mask_bits, mask_tablesize)
        return _scatter_hashes_i32(acc, h1, h2, valid, tablesize,
                                   counter_bits), None

    acc = _unpack_tables_i32(tables, counter_bits)
    acc, _ = jax.lax.scan(body, acc, bases_stack)
    return _pack_tables_i32(acc, maxcount, counter_bits)


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'maxcount', 'L', 'numbands',
                     'mask_threshold', 'consume_masked', 'has_mask',
                     'counter_bits', 'tablesize', 'mask_bits',
                     'mask_tablesize'),
    donate_argnames=('tables',))
def consume_batch_stack_packed(tables, packed_stack, badmask_stack, L, ksize,
                               maxcount, numbands=None, band=None,
                               mask_tables=None, has_mask=False,
                               mask_threshold=0, consume_masked=False,
                               counter_bits=8, tablesize=None, mask_bits=8,
                               mask_tablesize=None):
    """:func:`consume_batch_stack` over the 2-bit wire format (3.7x less
    host-to-device traffic); bases are unpacked on-device per scan step."""
    if counter_bits == 8:
        tablesize = tables.shape[1]

    def body(acc, inp):
        packed, badmask = inp
        bases = hashing.unpack_bases(packed, badmask, L)
        h1, h2, valid = hashing.kmer_hashes(bases, ksize)
        if numbands:
            valid = valid & ((h1 & jnp.uint32(numbands - 1))
                             == jnp.uint32(band))
        if has_mask:
            valid = _apply_mask_screen(mask_tables, h1, h2, valid,
                                       mask_threshold, consume_masked,
                                       mask_bits, mask_tablesize)
        return _scatter_hashes_i32(acc, h1, h2, valid, tablesize,
                                   counter_bits), None

    acc = _unpack_tables_i32(tables, counter_bits)
    acc, _ = jax.lax.scan(body, acc, (packed_stack, badmask_stack))
    return _pack_tables_i32(acc, maxcount, counter_bits)


@functools.partial(jax.jit,
                   static_argnames=('maxcount', 'counter_bits', 'tablesize'),
                   donate_argnames=('tables',))
def consume_hash_batch(tables, h1, h2, valid, maxcount, counter_bits=8,
                       tablesize=None):
    """Count pre-hashed k-mers (used by `filter` re-counting)."""
    new_tables = _consume_hashes(tables, h1, h2, valid, maxcount,
                                 counter_bits, tablesize)
    return new_tables, jnp.sum(valid.astype(jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=('ksize', 'counter_bits', 'tablesize'))
def query_batch(tables, bases, ksize, counter_bits=8, tablesize=None):
    """Counts for every k-mer of a padded read batch: [..., P] uint8."""
    h1, h2, valid = hashing.kmer_hashes(bases, ksize)
    counts = gather_counts(tables, h1, h2, counter_bits=counter_bits,
                           tablesize=tablesize)
    return jnp.where(valid, counts, jnp.uint8(0)), valid


@jax.jit
def occupancy(tables):
    """Occupied buckets in table 0 (khmer-style n_occupied)."""
    return jnp.sum((tables[0] > 0).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=('counter_bits', 'tablesize'))
def occupancy_packed(tables, counter_bits, tablesize):
    """Occupied buckets in table 0 for (possibly bit-packed) tables.

    A 4-byte device reduction instead of a full-table device->host mirror
    pull — the FPR estimate after counting no longer costs a tablesize
    transfer.  Sub-byte rows unpack PLANAR (layout-safe) and mask the
    padding buckets past ``tablesize``.
    """
    row = unpack_row_planar(tables[0], counter_bits)
    if counter_bits == 8:
        inrange = jnp.arange(row.shape[0], dtype=jnp.int32) < tablesize
    else:
        cpb = COUNTERS_PER_BYTE[counter_bits]
        nbytes = row.shape[0] // cpb
        byte = jnp.arange(nbytes, dtype=jnp.int32)
        bucket = jnp.concatenate([byte * cpb + p for p in range(cpb)])
        inrange = bucket < tablesize
    return jnp.sum(((row > 0) & inrange).astype(jnp.int32))
