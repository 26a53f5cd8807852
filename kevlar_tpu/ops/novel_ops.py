"""Fused device kernel for the novel-k-mer screen.

The reference's per-read Python loop (novel.py:95-176: per k-mer, point
lookups against every case then control sketch with short-circuiting) becomes
one jitted gather-compare pass per read batch: hash all windows once, gather
min-of-table counts from every sample's sketch, and evaluate the
casemin/ctrlmax predicate vectorised.
"""

import functools

import jax
import jax.numpy as jnp

from kevlar_tpu.ops import hashing, sketch_ops


def _pack_or_none(case_tables, ctrl_tables):
    """Packed-word table layout when every sample shares one shape.

    One uint32 gather then serves up to 4 samples (sketch_ops.
    pack_sample_tables); samples with heterogeneous table sizes fall back
    to per-sample gathers.
    """
    all_tables = tuple(case_tables) + tuple(ctrl_tables)
    if len(all_tables) > 1 and len({t.shape for t in all_tables}) == 1:
        return sketch_ops.pack_sample_tables(all_tables)
    return None


def _sample_counts(case_tables, ctrl_tables, packed, h1, h2):
    """uint8 [S, ...] min-of-table counts, cases then controls."""
    all_tables = tuple(case_tables) + tuple(ctrl_tables)
    if packed is not None:
        return sketch_ops.gather_counts_multi(packed, len(all_tables), h1, h2)
    return jnp.stack([sketch_ops.gather_counts(t, h1, h2)
                      for t in all_tables])


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'casemin', 'ctrlmax', 'screen', 'numbands'))
def novel_screen(case_tables, ctrl_tables, bases, lengths, ksize, casemin,
                 ctrlmax, screen=None, numbands=None, band=None, packed=None):
    """Screen a read batch for novel (interesting) k-mers.

    Parameters
    ----------
    case_tables / ctrl_tables : tuples of uint8 [ntables, tablesize] arrays
    bases : uint8 [B, L] padded base codes
    lengths : int32 [B] true read lengths

    Returns
    -------
    interesting : bool [B, P] — k-mer passes casemin in every case and
        ctrlmax in every control
    abunds : uint8 [S, B, P] — per-sample counts (cases then controls),
        in the order used for augmented-FASTX abundance tuples
    discard : bool [B] — read should be dropped entirely (abund-screen:
        first failing case abundance below `screen`)
    skip : bool [B] — read contains a non-ACGT base or is shorter than k
        (the reference skips such reads wholesale, novel.py:134-139)
    """
    B, L = bases.shape
    h1, h2, valid = hashing.kmer_hashes(bases, ksize)
    if numbands:
        valid = valid & ((h1 & jnp.uint32(numbands - 1)) == jnp.uint32(band))

    # reads with any invalid base (within their true length) are skipped
    bad = (bases >= 4).astype(jnp.int32)
    cumbad = jnp.cumsum(bad, axis=-1)
    total_bad = jnp.take_along_axis(
        jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cumbad], axis=1),
        lengths.astype(jnp.int32)[:, None], axis=1)[:, 0]
    skip = (total_bad > 0) | (lengths < ksize)

    if packed is None:
        packed = _pack_or_none(case_tables, ctrl_tables)
    counts = _sample_counts(case_tables, ctrl_tables, packed, h1, h2)
    C = len(case_tables)
    case_counts = counts[:C]
    if len(ctrl_tables):
        ctrl_counts = counts[C:]
    else:
        ctrl_counts = jnp.zeros((0,) + h1.shape, dtype=jnp.uint8)

    below = case_counts < jnp.uint8(casemin)          # [C, B, P]
    any_below = jnp.any(below, axis=0)
    if screen is not None:
        # abundance of the *first* case sample that fails casemin, mirroring
        # the reference's short-circuit order (novel.py:36-43)
        first_fail = jnp.argmax(below, axis=0)        # [B, P]
        fail_abund = jnp.take_along_axis(
            case_counts, first_fail[None], axis=0)[0]
        discard_kmer = valid & any_below & (fail_abund < jnp.uint8(screen))
        discard = jnp.any(discard_kmer, axis=-1) & ~skip
    else:
        discard = jnp.zeros((B,), dtype=bool)

    ctrl_ok = jnp.all(ctrl_counts <= jnp.uint8(ctrlmax), axis=0) \
        if len(ctrl_tables) else jnp.ones_like(any_below)
    interesting = valid & ~any_below & ctrl_ok & ~skip[:, None]

    abunds = jnp.concatenate([case_counts, ctrl_counts], axis=0)
    return interesting, abunds, discard, skip


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'casemin', 'ctrlmax', 'screen', 'numbands', 'max_hits'))
def novel_screen_compact(case_tables, ctrl_tables, bases, lengths, ksize,
                         casemin, ctrlmax, screen=None, numbands=None,
                         band=None, max_hits=32768, packed=None):
    """novel_screen + device-side compaction of the (sparse) hits.

    Instead of shipping the full [B, P] interest mask and [S, B, P] abundance
    tensor to the host, returns only the annotated positions:

    - hit_idx : int32 [max_hits] — flattened b*P + p indices of interesting
      k-mers (ascending; padded with -1)
    - hit_abunds : uint8 [S, max_hits] — per-sample abundances at those hits
    - n_hits : int32 — true number of hits (> max_hits means overflow: the
      caller should fall back to the uncompacted kernel)
    - discard, skip : bool [B]
    """
    interesting, abunds, discard, skip = novel_screen(
        case_tables, ctrl_tables, bases, lengths, ksize=ksize,
        casemin=casemin, ctrlmax=ctrlmax, screen=screen, numbands=numbands,
        band=band, packed=packed)
    flat = interesting.ravel()
    n_hits = jnp.sum(flat.astype(jnp.int32))
    (hit_idx,) = jnp.nonzero(flat, size=max_hits, fill_value=-1)
    S = abunds.shape[0]
    flat_abunds = abunds.reshape(S, -1)
    safe = jnp.maximum(hit_idx, 0)
    hit_abunds = jnp.where(hit_idx[None, :] >= 0,
                           flat_abunds[:, safe], jnp.uint8(0))
    return hit_idx, hit_abunds, n_hits, discard, skip


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'casemin', 'ctrlmax', 'screen', 'numbands', 'max_hits'))
def novel_screen_compact_stack(case_tables, ctrl_tables, bases_stack,
                               lengths_stack, ksize, casemin, ctrlmax,
                               screen=None, numbands=None, band=None,
                               max_hits=32768):
    """Compacted screen over a [NB, B, L] batch stack in ONE dispatch.

    Returns stacked per-batch results: hit_idx [NB, max_hits],
    hit_abunds [NB, S, max_hits], n_hits [NB], discard/skip [NB, B].
    """
    packed = _pack_or_none(case_tables, ctrl_tables)  # once, outside the scan

    def body(carry, inp):
        bases, lengths = inp
        outs = novel_screen_compact(
            case_tables, ctrl_tables, bases, lengths, ksize=ksize,
            casemin=casemin, ctrlmax=ctrlmax, screen=screen,
            numbands=numbands, band=band, max_hits=max_hits, packed=packed)
        return carry, outs

    _, outs = jax.lax.scan(body, 0, (bases_stack, lengths_stack))
    return outs


@functools.partial(
    jax.jit,
    static_argnames=('L', 'ksize', 'tablesize', 'ntables', 'maxcount',
                     'casemin', 'ctrlmax', 'screen', 'max_hits'))
def count_and_screen_stack_packed(case_packed, case_bad, ctrl_packed,
                                  ctrl_bad, lengths_stack, L, ksize,
                                  tablesize, ntables, maxcount, casemin,
                                  ctrlmax, screen=None, max_hits=32768):
    """The whole count+novel device pipeline as ONE compiled program.

    Counts every sample's [NB, B, ceil(L/4)] 2-bit packed read stack into a
    fresh 8-bit Count-Min sketch (a lax.scan per sample into an int32
    accumulator, as :func:`kevlar_tpu.ops.sketch_ops.consume_batch_stack`),
    packs the per-sample tables into interleaved uint32 words, then screens
    the case stack with device-side hit compaction — the reference's
    count+novel stages (count.py:18-99 + novel.py:95-176) in a single
    dispatch.

    Returns ((hit_idx, hit_abunds, n_hits, discard, skip) stacked per batch,
    case_tables, ctrl_tables).
    """
    from kevlar_tpu.ops import hashing as _h

    def consume_stack(packed_stack, bad_stack):
        def body(acc, inp):
            packed, badmask = inp
            bases = _h.unpack_bases(packed, badmask, L)
            h1, h2, valid = _h.kmer_hashes(bases, ksize)
            return sketch_ops._scatter_hashes_i32(
                acc, h1, h2, valid, tablesize), None

        acc = jnp.zeros((ntables, tablesize), jnp.int32)
        acc, _ = jax.lax.scan(body, acc, (packed_stack, bad_stack))
        return sketch_ops._pack_tables_i32(acc, maxcount, 8)

    case_tables = consume_stack(case_packed, case_bad)
    ctrl_tables = tuple(consume_stack(p, b)
                        for p, b in zip(ctrl_packed, ctrl_bad))
    packed_tables = _pack_or_none((case_tables,), ctrl_tables)

    def body(carry, inp):
        packed, badmask, lengths = inp
        bases = _h.unpack_bases(packed, badmask, L)
        outs = novel_screen_compact(
            (case_tables,), ctrl_tables, bases, lengths, ksize=ksize,
            casemin=casemin, ctrlmax=ctrlmax, screen=screen,
            max_hits=max_hits, packed=packed_tables)
        return carry, outs

    _, outs = jax.lax.scan(body, 0, (case_packed, case_bad, lengths_stack))
    return outs, case_tables, ctrl_tables


@functools.partial(
    jax.jit,
    static_argnames=('ksize', 'casemin', 'ctrlmax', 'screen', 'numbands', 'max_hits', 'L'))
def novel_screen_compact_stack_packed(case_tables, ctrl_tables, packed_stack,
                                      badmask_stack, lengths_stack, L, ksize,
                                      casemin, ctrlmax, screen=None,
                                      numbands=None, band=None,
                                      max_hits=32768):
    """Stacked compacted screen over the 2-bit wire format."""
    from kevlar_tpu.ops import hashing as _h

    packed_tables = _pack_or_none(case_tables, ctrl_tables)

    def body(carry, inp):
        packed, badmask, lengths = inp
        bases = _h.unpack_bases(packed, badmask, L)
        outs = novel_screen_compact(
            case_tables, ctrl_tables, bases, lengths, ksize=ksize,
            casemin=casemin, ctrlmax=ctrlmax, screen=screen,
            numbands=numbands, band=band, max_hits=max_hits,
            packed=packed_tables)
        return carry, outs

    _, outs = jax.lax.scan(body, 0,
                           (packed_stack, badmask_stack, lengths_stack))
    return outs
