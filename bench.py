"""Benchmark: count+novel throughput (reads/s/chip) on the device.

Generates a synthetic trio (tiled error-free reads over a random genome with
de novo SNVs in the proband), runs the full device pipeline — Count-Min
counting of all three samples plus the fused novel-k-mer screen of the case
reads — and reports one JSON line:

    {"metric": "count_novel_reads_per_s", "value": N, "unit": "reads/s",
     "vs_baseline": R}

``vs_baseline`` is the honest headline: the device against an *idealised
vectorised-numpy CPU baseline* — the same batched algorithm on the host,
far faster than the reference's actual per-read/per-k-mer loop.  The
faithful emulation of the reference architecture (khmer-style point
lookups driven by a per-read loop, the hot loop of reference
novel.py:95-176) is also measured and reported on stderr as
``vs_reference_architecture`` context; BASELINE.md's 10x "vs CPU kevlar"
target refers to that number.  Wall time covers compute on packed base
arrays (FASTQ parsing/marshalling excluded on all sides equally).
"""

import json
import os
import sys
import time

import numpy as np

KSIZE = 31
READLEN = 150
PADLEN = 160
BATCH = int(os.environ.get('KEVLAR_BENCH_BATCH', 8192))
GENOME_LEN = 200_000
COVERAGE = 30
TABLESIZE = 2_000_003
CASEMIN, CTRLMAX = 6, 1


def make_genome(rng, n):
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def tile_reads(genome, readlen, coverage, rng):
    n_reads = len(genome) * coverage // readlen
    starts = rng.integers(0, len(genome) - readlen, size=n_reads)
    idx = starts[:, None] + np.arange(readlen)[None, :]
    reads = genome[idx]
    out = np.full((n_reads, PADLEN), 4, dtype=np.uint8)
    out[:, :readlen] = reads
    return out


def batches(reads):
    for i in range(0, len(reads), BATCH):
        chunk = reads[i:i + BATCH]
        if len(chunk) < BATCH:
            pad = np.full((BATCH - len(chunk), PADLEN), 4, np.uint8)
            chunk = np.concatenate([chunk, pad])
        yield chunk


def stack_all(reads):
    """[N, PADLEN] -> [NB, BATCH, PADLEN] (rows padded with invalid)."""
    NB = -(-len(reads) // BATCH)
    out = np.full((NB * BATCH, PADLEN), 4, dtype=np.uint8)
    out[:len(reads)] = reads
    return out.reshape(NB, BATCH, PADLEN)


def device_pipeline(case_reads, ctrl_reads_list):
    """Count 3 samples + screen case reads on device. Returns wall seconds.

    The whole pipeline (consume all samples + packed-table screen) runs as
    ONE fused dispatch over the 2-bit packed wire format
    (novel_ops.count_and_screen_stack_packed): one H2D leg of packed reads,
    one device program, one compact D2H leg.
    """
    import jax.numpy as jnp
    from kevlar_tpu.batch import pack_bases
    from kevlar_tpu.ops import novel_ops

    all_reads = [case_reads] + ctrl_reads_list
    packed_stacks = [pack_bases(stack_all(r)) for r in all_reads]
    (case_packed, case_bad) = packed_stacks[0]
    ctrl_packed = tuple(p for p, _ in packed_stacks[1:])
    ctrl_bad = tuple(b for _, b in packed_stacks[1:])

    NB = case_packed.shape[0]
    lens = np.full((NB, BATCH), READLEN, np.int32)
    lens.reshape(-1)[len(case_reads):] = 0

    def run():
        outs, _, _ = novel_ops.count_and_screen_stack_packed(
            jnp.asarray(case_packed), jnp.asarray(case_bad),
            tuple(jnp.asarray(p) for p in ctrl_packed),
            tuple(jnp.asarray(b) for b in ctrl_bad),
            jnp.asarray(lens), L=PADLEN, ksize=KSIZE, tablesize=TABLESIZE,
            ntables=4, maxcount=255, casemin=CASEMIN, ctrlmax=CTRLMAX)
        hit_idx, hit_abunds, n_hits, discard, skip = outs
        return int(jnp.sum(n_hits))

    print('# bench: compiling fused count+screen pipeline...',
          file=sys.stderr, flush=True)
    run()
    print('# bench: compiled; timing device pipeline', file=sys.stderr,
          flush=True)

    # best-of-N to damp dispatch jitter
    best = None
    n_interesting = 0
    for rep in range(3):
        t0 = time.time()
        n_interesting = run()
        elapsed = time.time() - t0
        best = elapsed if best is None else min(best, elapsed)
    return best, n_interesting


def host_pipeline(case_reads, ctrl_reads_list):
    """Single-threaded numpy version of the same workload (CPU baseline)."""
    from kevlar_tpu import dna

    ntables = 4

    def consume(reads):
        tables = np.zeros((ntables, TABLESIZE), dtype=np.uint8)
        for i in range(0, len(reads), BATCH):
            chunk = reads[i:i + BATCH]
            h1, h2, valid = dna.kmer_hashes(chunk, KSIZE)
            h1f = h1[valid]
            h2f = h2[valid]
            for t in range(ntables):
                idx = (h1f + np.uint32(t) * h2f) % np.uint32(TABLESIZE)
                inc = np.bincount(idx.astype(np.int64), minlength=TABLESIZE)
                tables[t] = np.minimum(
                    tables[t].astype(np.int64) + inc, 255).astype(np.uint8)
        return tables

    def gather(tables, h1, h2):
        counts = None
        for t in range(ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(TABLESIZE)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        return counts

    t0 = time.time()
    all_tables = [consume(r) for r in [case_reads] + ctrl_reads_list]
    n_interesting = 0
    for i in range(0, len(case_reads), BATCH):
        chunk = case_reads[i:i + BATCH]
        h1, h2, valid = dna.kmer_hashes(chunk, KSIZE)
        case_counts = gather(all_tables[0], h1, h2)
        ok = valid & (case_counts >= CASEMIN)
        for tb in all_tables[1:]:
            ok &= gather(tb, h1, h2) <= CTRLMAX
        n_interesting += int(ok.sum())
    elapsed = time.time() - t0
    return elapsed, n_interesting


def reference_style_baseline(case_reads, ctrl_reads_list, tables_list,
                             nsub=2000):
    """Per-read loop with per-sample point lookups: the reference's novel
    hot path (novel.py:95-176), against pre-built host tables."""
    from kevlar_tpu import dna

    def gather(tables, h1, h2):
        counts = None
        for t in range(4):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(TABLESIZE)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        return counts

    sub = case_reads[:nsub]
    t0 = time.time()
    n_interesting = 0
    for read in sub:
        h1, h2, valid = dna.kmer_hashes(read[None, :], KSIZE)
        case_counts = gather(tables_list[0], h1[0], h2[0])
        keep = valid[0] & (case_counts >= CASEMIN)
        for tb in tables_list[1:]:
            ctrl_counts = gather(tb, h1[0], h2[0])
            keep &= ctrl_counts <= CTRLMAX
        n_interesting += int(keep.sum())
    elapsed = time.time() - t0
    # the counting pass is charged at the idealised vectorised rate (free
    # here), making this an upper bound on the reference's throughput
    return nsub / elapsed


def main():
    rng = np.random.default_rng(20260817)
    genome = make_genome(rng, GENOME_LEN)
    child = genome.copy()
    snv_positions = rng.choice(GENOME_LEN - 100, size=20, replace=False) + 50
    child[snv_positions] = (child[snv_positions] +
                            rng.integers(1, 4, size=len(snv_positions))) % 4

    case_reads = tile_reads(child, READLEN, COVERAGE, rng)
    mom_reads = tile_reads(genome, READLEN, COVERAGE, rng)
    dad_reads = tile_reads(genome, READLEN, COVERAGE, rng)
    total_reads = len(case_reads) * 2 + len(mom_reads) + len(dad_reads)

    device_s, dev_hits = device_pipeline(case_reads, [mom_reads, dad_reads])
    reads_per_s = total_reads / device_s

    # CPU baseline on a subset, extrapolated; best of 3 (the host number is
    # sensitive to machine contention)
    sub = max(len(case_reads) // 8, BATCH)
    host_s = None
    for rep in range(3):
        elapsed, host_hits = host_pipeline(
            case_reads[:sub], [mom_reads[:sub], dad_reads[:sub]])
        host_s = elapsed if host_s is None else min(host_s, elapsed)
    host_total = sub * 4
    host_reads_per_s = host_total / host_s

    # faithful reference-architecture baseline (per-read loop)
    from kevlar_tpu import dna as _dna

    def build_tables(reads):
        tables = np.zeros((4, TABLESIZE), dtype=np.uint8)
        h1, h2, valid = _dna.kmer_hashes(reads, KSIZE)
        h1f, h2f = h1[valid], h2[valid]
        for t in range(4):
            idx = (h1f + np.uint32(t) * h2f) % np.uint32(TABLESIZE)
            inc = np.bincount(idx.astype(np.int64), minlength=TABLESIZE)
            tables[t] = np.minimum(inc, 255).astype(np.uint8)
        return tables

    tables_list = [build_tables(r[:len(case_reads) // 4])
                   for r in (case_reads, mom_reads, dad_reads)]
    ref_reads_per_s = reference_style_baseline(
        case_reads, [mom_reads, dad_reads], tables_list)

    result = {
        'metric': 'count_novel_reads_per_s',
        'value': round(reads_per_s, 1),
        'unit': 'reads/s',
        'vs_baseline': round(reads_per_s / host_reads_per_s, 2),
    }
    print(json.dumps(result))
    print('# device: {:.2f}s for {} reads ({} interesting kmers)'.format(
        device_s, total_reads, dev_hits), file=sys.stderr)
    print('# idealised vectorised CPU baseline (the headline denominator): '
          '{:.2f}s for {} reads -> {:.0f} reads/s'.format(
              host_s, host_total, host_reads_per_s), file=sys.stderr)
    print('# reference-architecture CPU baseline (per-read loop, the '
          'BASELINE.md 10x target): {:.0f} reads/s -> '
          'vs_reference_architecture {:.1f}x'.format(
              ref_reads_per_s, reads_per_s / ref_reads_per_s),
          file=sys.stderr)


if __name__ == '__main__':
    main()
