"""Batched anti-diagonal wavefront aligner on the device (vmapped lax.scan).

Computes the exact ksw_extz DP (same cell arithmetic/tie-breaking as
:mod:`kevlar_tpu.ops.align`) for a batch of (target, query) pairs padded to
a common (T, Q).  Each anti-diagonal d = i + j is one scan step over a
width-T vector; the direction bytes come back as a [ndiag, T] array per pair
(``z[i, j] == zdiag[i + j, i]``) and the backtrack runs on the host.

This is the device path for call-stage scale (thousands of contig x cutout
pairs); the native C++ scalar aligner covers the host path.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kevlar_tpu.ops.align import NEG_INF, score_matrix


@functools.partial(
    jax.jit,
    static_argnames=('T', 'Q', 'match', 'mismatch', 'gapopen', 'gapextend'))
def _align_wavefront_batch(targets, tlens, queries, qlens, T, Q, match=1,
                           mismatch=2, gapopen=5, gapextend=0):
    """targets [B,T] uint8, queries [B,Q] uint8 -> (scores [B],
    zdiag [B, T+Q-1, T] uint8)."""
    mat = jnp.asarray(score_matrix(match, mismatch), dtype=jnp.int32)
    gapoe = gapopen + gapextend
    gape = gapextend
    ndiag = T + Q - 1
    ii = jnp.arange(T, dtype=jnp.int32)

    def one_with_score(target, tlen, query, qlen):
        sub = mat[jnp.minimum(target, 4)][:, jnp.minimum(query, 4)]

        def h_col(j):
            return jnp.where(j >= 1, -(gapoe + gape * (j - 1)), 0)

        def body(carry, d):
            H_prev, H_prev2, E_prev, F_prev, score = carry
            jj = d - ii
            inbounds = (ii < tlen) & (jj >= 0) & (jj < qlen)
            hd = jnp.where(ii >= 1, jnp.roll(H_prev2, 1), jnp.int32(NEG_INF))
            hd = jnp.where((ii == 0) & (jj >= 1), h_col(jj), hd)
            hd = jnp.where((jj == 0) & (ii >= 1),
                           -(gapoe + gape * (ii - 1)), hd)
            hd = jnp.where((ii == 0) & (jj == 0), 0, hd)
            e = jnp.maximum(jnp.roll(E_prev, 1) - gape,
                            jnp.roll(H_prev, 1) - gapoe)
            e = jnp.where(ii == 0, -(gapoe + gapoe + gape * jj), e)
            f = jnp.maximum(F_prev - gape, H_prev - gapoe)
            f = jnp.where(jj == 0, -(gapoe + gapoe + gape * ii), f)
            hdiag = hd + sub[ii, jnp.clip(jj, 0, Q - 1)]
            d0 = jnp.where(hdiag >= e, jnp.uint8(0), jnp.uint8(1))
            h = jnp.maximum(hdiag, e)
            d0 = jnp.where(h >= f, d0, jnp.uint8(2))
            h = jnp.maximum(h, f)
            hh = h - gapoe
            d0 = d0 | (((e - gape) > hh).astype(jnp.uint8) << 3)
            d0 = d0 | (((f - gape) > hh).astype(jnp.uint8) << 4)
            d0 = jnp.where(inbounds, d0, jnp.uint8(0))
            h = jnp.where(inbounds, h, jnp.int32(NEG_INF))
            e = jnp.where(inbounds, e, jnp.int32(NEG_INF))
            f = jnp.where(inbounds, f, jnp.int32(NEG_INF))
            # capture the final cell's H
            is_final = (ii == (tlen - 1)) & (jj == (qlen - 1))
            score = jnp.where(jnp.any(is_final),
                              jnp.max(jnp.where(is_final, h,
                                                jnp.int32(NEG_INF))),
                              score)
            return (h, H_prev, e, f, score), d0

        init = (jnp.full((T,), NEG_INF, jnp.int32),
                jnp.full((T,), NEG_INF, jnp.int32),
                jnp.full((T,), NEG_INF, jnp.int32),
                jnp.full((T,), NEG_INF, jnp.int32),
                jnp.int32(NEG_INF))
        (_, _, _, _, score), zdiag = jax.lax.scan(
            body, init, jnp.arange(ndiag, dtype=jnp.int32))
        return score, zdiag

    scores, zdiags = jax.vmap(one_with_score)(targets, tlens, queries, qlens)
    return scores, zdiags


@functools.partial(jax.jit, static_argnames=('T', 'Q'))
def _traceback_batch(zdiags, tlens, qlens, T, Q):
    """Device backtrack: walk the direction diagonals from (tlen-1, qlen-1)
    toward (0, 0) for every pair at once.

    Returns (ops_rev [B, T+Q] uint8, exit_i [B], exit_j [B]): per-step op
    codes in walk order (0=M, 1=D, 2=I, 3=inactive) plus the residual
    (i, j) for the leading gap run.  Only O(B*(T+Q)) bytes leave the
    device — the [B, T+Q-1, T] direction tensor never does.
    """
    nsteps = T + Q

    def one(zdiag, tlen, qlen):
        def body(carry, _):
            i, j, state, done = carry
            active = ~done
            ii = jnp.maximum(i, 0)
            jj = jnp.maximum(j, 0)
            tmp = zdiag[ii + jj, ii].astype(jnp.int32)
            cont = (tmp >> (state + 2)) & 1
            s1 = jnp.where(state == 0, tmp & 7,
                           jnp.where(cont == 0, 0, state))
            s2 = jnp.where(s1 == 0, tmp & 7, s1)
            op = jnp.where(active, s2.astype(jnp.uint8), jnp.uint8(3))
            di = ((s2 == 0) | (s2 == 1)).astype(jnp.int32)
            dj = ((s2 == 0) | (s2 == 2)).astype(jnp.int32)
            i2 = jnp.where(active, i - di, i)
            j2 = jnp.where(active, j - dj, j)
            done2 = done | (i2 < 0) | (j2 < 0)
            return (i2, j2, s2, done2), op

        init = (tlen - 1, qlen - 1, jnp.int32(0),
                (tlen <= 0) | (qlen <= 0))
        (fi, fj, _, _), ops = jax.lax.scan(body, init, None, length=nsteps)
        return ops, fi, fj

    return jax.vmap(one)(zdiags, tlens.astype(jnp.int32),
                         qlens.astype(jnp.int32))


_OPCHARS = 'MDI'


def _cigar_from_ops(ops_rev, exit_i, exit_j):
    """Host assembly: reverse the walk, run-length encode, add the leading
    gap run — identical output to ops.align._backtrack."""
    parts = []  # built in walk order, reversed at the end
    for op in ops_rev:
        if op == 3:
            break
        opc = _OPCHARS[op]
        if parts and parts[-1][0] == opc:
            parts[-1][1] += 1
        else:
            parts.append([opc, 1])
    if exit_i >= 0:
        if parts and parts[-1][0] == 'D':
            parts[-1][1] += exit_i + 1
        else:
            parts.append(['D', exit_i + 1])
    if exit_j >= 0:
        if parts and parts[-1][0] == 'I':
            parts[-1][1] += exit_j + 1
        else:
            parts.append(['I', exit_j + 1])
    parts.reverse()
    return ''.join('{}{}'.format(n, c) for c, n in parts)


def _cigars_from_ops_batch(ops_np, exit_i_np, exit_j_np):
    """Vectorised host assembly of a whole batch's CIGARs.

    Run-length encodes each row with numpy (op codes are monotone-inactive
    after the walk ends, so the first ``3`` bounds the row) and only loops
    Python over *runs* (a CIGAR has a handful) instead of *steps* (T+Q per
    pair).  Output identical to
    :func:`_cigar_from_ops` row by row (pinned in tests)."""
    B, S = ops_np.shape
    exit_i_np = np.asarray(exit_i_np)
    exit_j_np = np.asarray(exit_j_np)
    # one global RLE over the row-flattened matrix (a 255 sentinel column
    # separates rows); Python then only touches real runs, of which a
    # CIGAR has a handful
    padded = np.concatenate(
        [ops_np, np.full((B, 1), 255, np.uint8)], axis=1).ravel()
    cuts = np.flatnonzero(padded[1:] != padded[:-1]) + 1
    starts = np.concatenate(([0], cuts))
    ends = np.concatenate((cuts, [padded.size]))
    vals = padded[starts]
    keep = vals < 3                       # drop inactive tails + sentinels
    starts, ends, vals = starts[keep], ends[keep], vals[keep]
    rows = starts // (S + 1)
    counts = ends - starts
    run_of_row = np.split(np.arange(starts.size),
                          np.searchsorted(rows, np.arange(1, B)))
    out = []
    for b in range(B):
        parts = [[_OPCHARS[vals[r]], int(counts[r])] for r in run_of_row[b]]
        ei = int(exit_i_np[b])
        ej = int(exit_j_np[b])
        if ei >= 0:
            if parts and parts[-1][0] == 'D':
                parts[-1][1] += ei + 1
            else:
                parts.append(['D', ei + 1])
        if ej >= 0:
            if parts and parts[-1][0] == 'I':
                parts[-1][1] += ej + 1
            else:
                parts.append(['I', ej + 1])
        parts.reverse()
        out.append(''.join('{}{}'.format(n, c) for c, n in parts))
    return out


def _bucket(n, floor=64):
    b = floor
    while b < n:
        b *= 2
    return b


# Cap on one dispatch's [B, T+Q-1, T] uint8 direction tensor.  It holds a
# whole-run global batch to a small, fixed share of device memory (0.6% of
# an 80 GB card), which the sample sketches and the int32 consume
# accumulator need too, and still admits 512 pairs per dispatch at the
# 512x512 bucket.  Whether a larger cap speeds the device aligner is open
# (ROADMAP Speed #6).
_ZDIAG_BUDGET_BYTES = 512e6


def align_batch(target_seqs, query_seqs, match=1, mismatch=2, gapopen=5,
                gapextend=0, mesh=None, group_buckets=False):
    """Align many (target, query) string pairs on device; returns
    [(cigar, score), ...] with exact ksw2 semantics.

    Pairs are padded to shared (T, Q) buckets and the batch axis is padded
    to a power of two, so the number of distinct compiled programs stays
    O(log T * log Q * log B) no matter how partition sizes vary.  Backtrack
    runs on device; only O(B*(T+Q)) bytes come back.

    ``mesh`` shards the batch axis across every device of the mesh (the DP
    is embarrassingly parallel over pairs, so plain input shardings let XLA
    partition it — the device replacement for the reference's N parallel
    ``call`` shard processes, Snakefile:345-356).

    ``group_buckets`` splits a size-heterogeneous pair list into per-
    (T, Q)-bucket dispatches instead of padding everything to the global
    maximum — intended for whole-run global batches (the fused alac path),
    where one oversized cutout would otherwise quadratically inflate every
    pair's DP.
    """
    from kevlar_tpu import dna

    B = len(target_seqs)
    assert len(query_seqs) == B
    if B == 0:
        return []

    if group_buckets:
        keys = [( _bucket(len(t)), _bucket(len(q)))
                for t, q in zip(target_seqs, query_seqs)]
        if len(set(keys)) > 1:
            groups = {}
            for idx, key in enumerate(keys):
                groups.setdefault(key, []).append(idx)
            results = [None] * B
            for key in sorted(groups):
                idxs = groups[key]
                sub = align_batch([target_seqs[i] for i in idxs],
                                  [query_seqs[i] for i in idxs],
                                  match=match, mismatch=mismatch,
                                  gapopen=gapopen, gapextend=gapextend,
                                  mesh=mesh)
                for i, r in zip(idxs, sub):
                    results[i] = r
            return results

    T = _bucket(max((len(t) for t in target_seqs), default=1))
    Q = _bucket(max((len(q) for q in query_seqs), default=1))
    # the direction tensor is [B, T+Q-1, T] uint8 in HBM: cap each dispatch
    # so a whole-run global batch (thousands of pairs) can't blow past the
    # device memory budget; full chunks share one compiled shape
    zbytes = (T + Q - 1) * T
    bmax = 8
    while bmax * 2 * zbytes <= _ZDIAG_BUDGET_BYTES:
        bmax *= 2
    if B > bmax:
        results = []
        for lo in range(0, B, bmax):
            results += align_batch(
                target_seqs[lo:lo + bmax], query_seqs[lo:lo + bmax],
                match=match, mismatch=mismatch, gapopen=gapopen,
                gapextend=gapextend, mesh=mesh)
        return results
    Bpad = _bucket(B, floor=8)
    if mesh is not None:
        ndev = int(np.prod(list(mesh.shape.values())))
        if Bpad % ndev:
            Bpad = -(-Bpad // ndev) * ndev
    pad_rows = [''] * (Bpad - B)
    targets, tlens = dna.encode_batch(list(target_seqs) + pad_rows, pad_to=T)
    queries, qlens = dna.encode_batch(list(query_seqs) + pad_rows, pad_to=Q)

    if mesh is None:
        dev = (jnp.asarray(targets), jnp.asarray(tlens),
               jnp.asarray(queries), jnp.asarray(qlens))
    else:
        from jax.sharding import NamedSharding, PartitionSpec
        batch_sharding = NamedSharding(mesh, PartitionSpec(mesh.axis_names))
        dev = tuple(jax.device_put(x, batch_sharding)
                    for x in (targets, tlens, queries, qlens))
    scores, zdiags = _align_wavefront_batch(
        dev[0], dev[1], dev[2], dev[3], T=T, Q=Q, match=match,
        mismatch=mismatch, gapopen=gapopen, gapextend=gapextend)
    ops_rev, exit_i, exit_j = _traceback_batch(
        zdiags, dev[1], dev[3], T=T, Q=Q)
    scores = np.asarray(scores)
    ops_rev = np.asarray(ops_rev)
    exit_i = np.asarray(exit_i)
    exit_j = np.asarray(exit_j)

    cigars = _cigars_from_ops_batch(ops_rev[:B], exit_i[:B], exit_j[:B])
    return [(cigars[b], int(scores[b])) for b in range(B)]
