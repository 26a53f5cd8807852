"""``warm``: pre-compile the pipeline's device programs into the cache.

Cold-start compiles dominate small runs.  The persistent XLA compile cache
(enabled by ``kevlar_tpu.__init__``) makes every compile a one-time cost —
this command pays those costs ahead of data, by driving the REAL stage
code (count.consume_seqfile, novel.novel, the batched aligner) over tiny
synthetic inputs with exactly the production shapes.  Compiled programs
are keyed by (ksize, table size, batch geometry), so pass the same ``-k``
/ ``-M`` / read length you will use for real data.

Usage:
    kevlar warm -k 31 -M 8M --readlen 150                # count + novel
    kevlar warm -k 31 -M 8M --mask-memory 1M             # + masked count
    kevlar warm -k 31 -M 8M --refr-memory 4M             # + 4-bit genome count
    kevlar warm --align-buckets 256x256,512x512          # + aligner shapes

Run it once per sketch-size configuration (e.g. right after editing a
workflow config); every later stage start is then a cache hit.
"""

import os
import sys
import tempfile
import time

import numpy as np

import kevlar_tpu


def _synth_fastq(path, nreads, readlen, seed=7):
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b'ACGT', np.uint8)
    with open(path, 'wb') as fh:
        for i in range(nreads):
            seq = lut[rng.integers(0, 4, size=readlen)].tobytes()
            fh.write(b'@w%d\n%s\n+\n%s\n' % (i, seq, b'I' * readlen))


def warm(ksize=31, memory=8e6, readlen=150, ncontrols=2, maskmem=None,
         refrmem=None, alignbuckets=(), batch_size=None, log=kevlar_tpu.plog):
    from kevlar_tpu import count as count_mod
    from kevlar_tpu import novel as novel_mod
    from kevlar_tpu.batch import DEFAULT_BATCH_SIZE
    from kevlar_tpu.sketch import allocate_from_memory

    batch_size = batch_size or DEFAULT_BATCH_SIZE
    nreads = batch_size + 1  # two batches -> the stacked (depth-8) program
    t_all = time.time()
    with tempfile.TemporaryDirectory(prefix='kevlar_warm_') as tmp:
        fq = os.path.join(tmp, 'warm.fq')
        _synth_fastq(fq, nreads, readlen)

        log('[kevlar::warm] count program (8-bit, -M {:g})'.format(memory))
        t0 = time.time()
        sketches = []
        for _ in range(1 + ncontrols):
            sk = allocate_from_memory(ksize, memory)
            count_mod.consume_seqfile(sk, [fq], batch_size=batch_size)
            sketches.append(sk)
        log('[kevlar::warm]   {:.1f}s'.format(time.time() - t0))

        if maskmem:
            log('[kevlar::warm] masked-count program (mask -M {:g})'.format(
                maskmem))
            t0 = time.time()
            mask = allocate_from_memory(ksize, maskmem, counter_bits=1)
            mask.consume('A' * ksize + 'C' * ksize)
            sk = allocate_from_memory(ksize, memory)
            count_mod.consume_seqfile(sk, [fq], mask=mask,
                                      batch_size=batch_size)
            count_mod.consume_seqfile(sk, [fq], mask=mask,
                                      consume_masked=True,
                                      batch_size=batch_size)
            log('[kevlar::warm]   {:.1f}s'.format(time.time() - t0))

        if refrmem:
            log('[kevlar::warm] genome-count program (4-bit, chunked, '
                '-M {:g})'.format(refrmem))
            t0 = time.time()
            fa = os.path.join(tmp, 'warm.fa')
            rng = np.random.default_rng(11)
            lut = np.frombuffer(b'ACGT', np.uint8)
            with open(fa, 'wb') as fh:
                fh.write(b'>w\n')
                fh.write(lut[rng.integers(0, 4, size=5000)].tobytes())
                fh.write(b'\n')
            sk = allocate_from_memory(ksize, refrmem, counter_bits=4)
            count_mod.consume_seqfile(sk, [fa], batch_size=batch_size)
            log('[kevlar::warm]   {:.1f}s'.format(time.time() - t0))

        log('[kevlar::warm] novel screen program ({} control(s))'.format(
            ncontrols))
        t0 = time.time()
        for _ in novel_mod.novel(None, sketches[:1], sketches[1:],
                                 ksize=ksize, casemin=2, ctrlmax=1,
                                 batchstream=iter(
                                     kevlar_tpu.batch.batches_from_records(
                                         _records(nreads, readlen),
                                         batch_size)),
                                 emit='text'):
            pass
        log('[kevlar::warm]   {:.1f}s'.format(time.time() - t0))

        for bucket in alignbuckets:
            dims = [int(x) for x in bucket.lower().split('x')]
            T, Q = dims[0], dims[1]
            B = dims[2] if len(dims) > 2 else 8
            log('[kevlar::warm] aligner bucket T={} Q={} B={}'.format(
                T, Q, B))
            t0 = time.time()
            from kevlar_tpu.ops.align import align_both_strands_batch
            rng = np.random.default_rng(3)
            lut = 'ACGT'
            pairs = []
            for _ in range(max(1, B // 2)):
                t = ''.join(lut[c] for c in rng.integers(0, 4, size=T // 2 + 1))
                q = ''.join(lut[c] for c in rng.integers(0, 4, size=Q // 2 + 1))
                pairs.append((t, q))
            align_both_strands_batch(pairs)
            log('[kevlar::warm]   {:.1f}s'.format(time.time() - t0))

    log('[kevlar::warm] cache warmed in {:.1f}s total; subsequent stage '
        'starts for these shapes are compile-free'.format(
            time.time() - t_all))


def _records(nreads, readlen):
    from kevlar_tpu.sequence import Record
    rng = np.random.default_rng(13)
    lut = 'ACGT'
    for i in range(nreads):
        seq = ''.join(lut[c] for c in rng.integers(0, 4, size=readlen))
        yield Record(name='w{}'.format(i), sequence=seq)


def main(args):
    warm(ksize=args.ksize, memory=args.memory, readlen=args.readlen,
         ncontrols=args.controls, maskmem=args.mask_memory,
         refrmem=args.refr_memory,
         alignbuckets=(args.align_buckets.split(',')
                       if args.align_buckets else ()))


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('-k', '--ksize', type=int, default=31)
    ap.add_argument('-M', '--memory', type=float, default=8e6)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--controls', type=int, default=2)
    ap.add_argument('--mask-memory', type=float, default=None)
    ap.add_argument('--refr-memory', type=float, default=None)
    ap.add_argument('--align-buckets', default=None)
    kevlar_tpu.logstream = sys.stderr
    main(ap.parse_args())
