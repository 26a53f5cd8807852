"""``novel`` stage: find reads containing novel (case-only) k-mers.

Parity with /root/reference/kevlar/novel.py: a k-mer is interesting iff its
abundance is >= `casemin` in every case sample and <= `ctrlmax` in every
control sample; reads with any k-mer below the abundance screen are discarded
entirely; reads shorter than k or containing non-ACGT bases are skipped;
emitted records carry (kmer, offset, abundance-tuple) annotations.

Banding note: the user-facing `--band` is 1-based.  Internally band b of N
keeps k-mers with ``hash & (N-1) == b`` consistently across count and novel
(the reference novel loop has an extra off-by-one, novel.py:144-147, which is
internally inconsistent with its own count stage; we use the consistent
semantics — SURVEY.md §7 hard-part (e)).
"""

import numpy as np

import kevlar_tpu
from kevlar_tpu import batch as batch_mod
from kevlar_tpu import sequence
from kevlar_tpu.ops import novel_ops


class KevlarCaseSampleMismatchError(ValueError):
    pass


class _LazyRecords:
    """Record accessor over native-parser arrays: Records are materialised
    only for reads that actually carry novel k-mers."""

    def __init__(self, bases, lengths, names, quals):
        self._bases = bases
        self._lengths = lengths
        self._names = names
        self._quals = quals
        self._cache = {}

    def __len__(self):
        return len(self._names)

    def __getitem__(self, i):
        if i not in self._cache:
            from kevlar_tpu import dna
            L = int(self._lengths[i])
            seq = dna.decode(self._bases[i, :L])
            qual = None
            if self._quals is not None:
                q = bytes(self._quals[i, :L]).decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
            self._cache[i] = sequence.Record(
                name=self._names[i], sequence=seq, quality=qual)
        return self._cache[i]


class _NativeBatch:
    """ReadBatch-compatible view over native parser output."""

    __slots__ = ('bases', 'lengths', 'records', 'names', 'n')

    def __init__(self, bases, lengths, names, quals, pad_rows):
        self.n = len(names)
        self.names = names
        if bases.shape[0] < pad_rows:
            bases = np.concatenate([
                bases,
                np.full((pad_rows - bases.shape[0], bases.shape[1]), 4,
                        np.uint8)])
            lengths = np.concatenate([
                lengths, np.zeros(pad_rows - len(lengths), np.int32)])
        self.bases = bases
        self.lengths = lengths
        self.records = _LazyRecords(bases, lengths, names, quals)

    def __len__(self):
        return self.n


def native_read_batches(files, batch_size, max_len=1024):
    """Stream _NativeBatch objects via the C++ parser (raises ImportError
    when the native library is unavailable)."""
    from kevlar_tpu import native
    from kevlar_tpu.batch import bucket_length
    for path in files:
        reader = native.FastxBatchReader(path, max_reads=batch_size,
                                         max_len=max_len, want_quals=True)
        bucket = 0
        for bases, lengths, names, quals in reader:
            maxlen = int(lengths.max()) if len(lengths) else 0
            bucket = max(bucket, bucket_length(maxlen))
            yield _NativeBatch(np.ascontiguousarray(bases[:, :bucket]),
                               lengths, names,
                               quals[:, :bucket] if quals is not None
                               else None, batch_size)


def load_samples(counttables=None, filelists=None, ksize=31, memory=1e6,
                 maxfpr=0.2, numbands=None, band=None, numthreads=1,
                 outfilelist=None, mesh=None):
    from kevlar_tpu import count as count_mod
    from kevlar_tpu import sketch as sketch_mod
    assert counttables or filelists
    if counttables:
        message = 'counttables for {:d} sample(s) provided'.format(
            len(counttables))
        message += ', any corresponding FASTA/FASTQ input will be ignored'
        kevlar_tpu.plog('[kevlar::novel]    INFO:', message)
        samples = sketch_mod.load_sketchfiles(counttables, maxfpr)
        if mesh is not None:
            from kevlar_tpu.parallel import ShardedSketch
            samples = [ShardedSketch.from_sketch(mesh, s) for s in samples]
        return samples
    samples = []
    for filelist in filelists:
        sample = count_mod.load_sample_seqfile(
            filelist, ksize, memory, maxfpr=maxfpr, numbands=numbands,
            band=band, numthreads=numthreads, mesh=mesh)
        samples.append(sample)
    if outfilelist:
        save_counts(outfilelist, samples)
    return samples


def save_counts(filelist, tablelist):
    if len(filelist) != len(tablelist):
        msg = ('number of filenames provided ({:d}) does not match the number '
               'of samples provided ({:d}); stubbornly refusing to save '
               'k-mer counts'.format(len(filelist), len(tablelist)))
        kevlar_tpu.plog('[kevlar::novel] WARNING:', msg)
        return
    for outfile, counttable in zip(filelist, tablelist):
        if not outfile.endswith(('.ct', '.counttable')):
            outfile += '.counttable'
        kevlar_tpu.plog('    saved to "{}"'.format(outfile))
        counttable.save(outfile)


_ASCII_BASES = np.frombuffer(b'ACGTN', dtype=np.uint8)


def novel(casestream, casecounts, controlcounts, ksize=31, abundscreen=None,
          casemin=5, ctrlmax=0, numbands=None, band=None, skipuntil=None,
          batch_size=batch_mod.DEFAULT_BATCH_SIZE, updateint=1e6,
          batchstream=None, emit='records'):
    """Generator yielding annotated (augmented) records with novel k-mers.

    ``emit='text'`` yields preformatted augmented-FASTX text blocks (one
    per screened batch) instead of Records: the hit arrays are serialised
    columnar-to-text without materialising per-read Python objects — the
    production write path (used by ``main``).
    """
    numbands_unset = not numbands
    band_unset = not band and band != 0
    if numbands_unset is not band_unset:
        raise ValueError('Must specify `numbands` and `band` together')
    if band is not None and band < 0:
        message = ('`band` must be a value between 0 and {:d} (`numbands` - '
                   '1), inclusive'.format(numbands - 1))
        raise ValueError(message)

    timer = kevlar_tpu.Timer()
    timer.start()
    nkmers = 0
    nreads = 0
    nprocessed = 0
    unique_kmers = set()
    from kevlar_tpu.parallel.sharded import ShardedSketch
    from kevlar_tpu.oxli import OxliSketch
    sharded = isinstance(casecounts[0], ShardedSketch)
    # khmer-format counttables (loaded .ct/.sct files) have per-table prime
    # sizes and the 64-bit khmer hash — they screen on the host engine
    # (vectorised numpy per read), not the device tables
    hostsketch = (not sharded) and any(
        isinstance(s, OxliSketch)
        for s in tuple(casecounts) + tuple(controlcounts))
    if not sharded and not hostsketch:
        case_tables = tuple(s.tables for s in casecounts)
        ctrl_tables = tuple(s.tables for s in controlcounts)
    skipping = skipuntil is not None

    progress = kevlar_tpu.ProgressIndicator(
        '[kevlar::novel]     processed {counter} reads', interval=updateint,
        breaks=[1e7, 1e8, 1e9], usetimer=True)

    if batchstream is None:
        batchstream = batch_mod.batches_from_records(casestream, batch_size)
    if not hostsketch:
        # parse/marshal one window ahead on a background thread so the
        # device screen never waits on the parser (KEVLAR_PREFETCH=0
        # disables; order is preserved)
        batchstream = batch_mod.prefetch_iter(batchstream, depth=6)

    def decode_hits(rbatch, hits_np, hitab_np, discard):
        """Turn compacted hit indices into annotated Records."""
        nonlocal nreads, nkmers
        P = rbatch.bases.shape[1] - ksize + 1
        irecord = None
        last_i = -1
        for h in range(len(hits_np)):
            i, p = divmod(int(hits_np[h]), P)
            if i >= len(rbatch.records) or discard[i]:
                continue
            if i != last_i:
                if irecord is not None and irecord.annotations:
                    nreads += 1
                    nkmers += len(irecord.annotations)
                    yield irecord
                irecord = sequence.copy_record(rbatch.records[i])
                last_i = i
            record = rbatch.records[i]
            kmer = record.sequence[p:p + ksize]
            irecord.annotate(kmer, p, tuple(int(a) for a in hitab_np[:, h]))
            unique_kmers.add(kevlar_tpu.revcommin(kmer))
        if irecord is not None and irecord.annotations:
            nreads += 1
            nkmers += len(irecord.annotations)
            yield irecord

    def row_fields(rbatch, r):
        """(name, sequence, quality) for one batch row without building a
        Record: native batches decode straight from the columnar arrays."""
        recs = rbatch.records
        if isinstance(recs, _LazyRecords):
            L = int(recs._lengths[r])
            seq = _ASCII_BASES[rbatch.bases[r, :L]].tobytes().decode('ascii')
            qual = None
            if recs._quals is not None:
                q = recs._quals[r, :L].tobytes().decode('ascii', 'replace')
                qual = q if q.strip('\x00') else None
            return recs._names[r], seq, qual
        rec = recs[r]
        return rec.name, rec.sequence, getattr(rec, 'quality', None)

    def format_hits(rbatch, hits_np, hitab_np, discard):
        """Serialise one batch's hits straight to augmented-FASTX text
        (the production write path: no Record objects, no per-record
        write calls — columnar arrays to one text block)."""
        nonlocal nreads, nkmers
        if not len(hits_np):
            return ''
        P = rbatch.bases.shape[1] - ksize + 1
        hits_np = np.asarray(hits_np)
        i = hits_np // P
        p = hits_np - i * P
        n = len(rbatch.records)
        ok = (i < n) & ~np.asarray(discard)[np.minimum(i, len(discard) - 1)]
        if not ok.all():
            i, p, hitab_np = i[ok], p[ok], np.asarray(hitab_np)[:, ok]
        if not len(i):
            return ''
        # hits arrive in ascending flat order (ascending read, then offset)
        boundaries = np.flatnonzero(np.diff(i)) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [len(i)]))
        abstr = [' '.join(map(str, col))
                 for col in np.asarray(hitab_np).T.tolist()]
        parts = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            r = int(i[s])
            name, seq, qual = row_fields(rbatch, r)
            if qual is not None:
                parts.append('@{}\n{}\n+\n{}\n'.format(name, seq, qual))
            else:
                parts.append('>{}\n{}\n'.format(name, seq))
            for j in range(s, e):
                off = int(p[j])
                kmer = seq[off:off + ksize]
                parts.append('{}{}          {}#\n'.format(
                    ' ' * off, kmer, abstr[j]))
                unique_kmers.add(kevlar_tpu.revcommin(kmer))
            nreads += 1
            nkmers += e - s
        return ''.join(parts)

    def record_text(record):
        import io
        buf = io.StringIO()
        sequence.print_augmented_fastx(record, buf)
        return buf.getvalue()

    def host_screen(rbatch):
        """Reference-semantics screen against host-engine sketches (khmer
        .ct/.sct interop): per read, every sample's k-mer counts gathered
        in one vectorised query; a case abundance below `abundscreen`
        discards the read (reference novel.py:40-43), non-ACGT reads are
        skipped (novel.py:134-139), banding keeps k-mers whose (sketch)
        hash satisfies ``hash & (numbands-1) == band`` (novel.py:144-147).
        """
        nonlocal nreads, nkmers
        samples = tuple(casecounts) + tuple(controlcounts)
        ncase = len(casecounts)
        for record in rbatch.records:
            seq = record.sequence
            if len(seq) < ksize or any(b not in 'ACGT' for b in seq):
                continue
            counts = np.array([s.get_kmer_counts(seq) for s in samples])
            interesting = np.all(counts[:ncase] >= casemin, axis=0) & \
                np.all(counts[ncase:] <= ctrlmax, axis=0)
            inband = np.ones(counts.shape[1], dtype=bool)
            if numbands:
                hashes = np.array(casecounts[0].get_kmer_hashes(seq),
                                  dtype=np.uint64)
                inband = (hashes & np.uint64(numbands - 1)) == np.uint64(band)
                interesting &= inband
            # out-of-band k-mers never reach the screen check (reference
            # novel.py:144-154 ordering)
            if abundscreen is not None and \
                    bool((counts[:ncase, inband] < abundscreen).any()):
                continue
            positions = np.nonzero(interesting)[0]
            if not len(positions):
                continue
            irecord = sequence.copy_record(record)
            for p in positions:
                kmer = seq[p:p + ksize]
                irecord.annotate(kmer, int(p),
                                 tuple(int(c) for c in counts[:, p]))
                unique_kmers.add(kevlar_tpu.revcommin(kmer))
            nreads += 1
            nkmers += len(positions)
            yield irecord

    def screen_one(rbatch):
        """Single-batch screen with overflow fallback; returns decode args."""
        hit_idx, hit_abunds, n_hits, discard, skip = \
            novel_ops.novel_screen_compact(
                case_tables, ctrl_tables, rbatch.bases, rbatch.lengths,
                ksize=ksize, casemin=casemin, ctrlmax=ctrlmax,
                screen=abundscreen, numbands=numbands, band=band)
        n_hits = int(n_hits)
        if n_hits > hit_idx.shape[0]:
            # compaction overflow (extremely k-mer-dense batch): fall back
            # to the full mask
            interesting, abunds, discard, skip = novel_ops.novel_screen(
                case_tables, ctrl_tables, rbatch.bases, rbatch.lengths,
                ksize=ksize, casemin=casemin, ctrlmax=ctrlmax,
                screen=abundscreen, numbands=numbands, band=band)
            flat = np.nonzero(np.asarray(interesting).ravel())[0]
            abunds_np = np.asarray(abunds).reshape(
                len(case_tables) + len(ctrl_tables), -1)
            return flat, abunds_np[:, flat], np.asarray(discard)
        return (np.asarray(hit_idx)[:n_hits],
                np.asarray(hit_abunds)[:, :n_hits], np.asarray(discard))

    # stacked dispatch: consecutive same-shape batches are screened 8 at a
    # time in a single device program (dispatch overhead paid once per
    # stack).  Only
    # consecutive runs are stacked so the output order stays identical to
    # the input order.  Dispatches are pipelined: up to MAX_INFLIGHT stacks
    # are enqueued on the device (jax dispatch is asynchronous) before the
    # oldest result is forced, so host-side parsing/marshalling of stack
    # N+1 and its host->device transfer overlap the device screen of stack
    # N.  Results are collected FIFO, so output order stays input order.
    STACK_DEPTH = 8
    # in-flight device stacks: higher overlaps more H2D/compute at the
    # cost of device memory for the queued batches (validated range 1-8)
    import os as _os_inflight
    MAX_INFLIGHT = int(_os_inflight.environ.get('KEVLAR_MAX_INFLIGHT', '3'))
    if not 1 <= MAX_INFLIGHT <= 8:
        raise ValueError('KEVLAR_MAX_INFLIGHT must be in [1, 8]')
    emit_text = (emit == 'text')
    pending = []
    from collections import deque
    inflight = deque()

    def dispatch_stack(stack):
        """Enqueue one stack on the device; results are not forced here."""
        if len(stack) == 1:
            return (stack, None)
        nreal = len(stack)
        bases_stack = np.stack(
            [b.bases for b in stack] +
            [np.full_like(stack[0].bases, 4)] * (STACK_DEPTH - nreal))
        lengths_stack = np.stack(
            [np.asarray(b.lengths, np.int32) for b in stack] +
            [np.zeros_like(np.asarray(stack[0].lengths, np.int32))] *
            (STACK_DEPTH - nreal))
        import os
        if os.environ.get('KEVLAR_PACKED_WIRE', '1') != '0':
            # 2-bit wire format: ~3.7x less host->device traffic on the
            # hottest stage (same opt-out as count)
            packed_stack, badmask_stack = batch_mod.pack_bases(bases_stack)
            res = novel_ops.novel_screen_compact_stack_packed(
                case_tables, ctrl_tables, packed_stack, badmask_stack,
                lengths_stack, L=bases_stack.shape[-1], ksize=ksize,
                casemin=casemin, ctrlmax=ctrlmax,
                screen=abundscreen, numbands=numbands, band=band)
        else:
            res = novel_ops.novel_screen_compact_stack(
                case_tables, ctrl_tables, bases_stack, lengths_stack,
                ksize=ksize, casemin=casemin, ctrlmax=ctrlmax,
                screen=abundscreen, numbands=numbands, band=band)
        return (stack, res)

    def collect(entry):
        """Force one in-flight stack's results and decode them."""
        stack, res = entry
        if res is None:
            rbatch = stack[0]
            hits_np, hitab_np, disc = screen_one(rbatch)
            if emit_text:
                yield format_hits(rbatch, hits_np, hitab_np, disc)
            else:
                yield from decode_hits(rbatch, hits_np, hitab_np, disc)
            return
        hit_idx, hit_abunds, n_hits, discard, skip = res
        n_hits_np = np.asarray(n_hits)
        hit_idx_np = np.asarray(hit_idx)
        hit_abunds_np = np.asarray(hit_abunds)
        discard_np = np.asarray(discard)
        for j, rbatch in enumerate(stack):
            nh = int(n_hits_np[j])
            if nh > hit_idx_np.shape[1]:
                # compaction overflow (extremely k-mer-dense batch): rerun
                # this batch through the full-mask fallback
                hits_np, hitab_np, disc = screen_one(rbatch)
            else:
                hits_np = hit_idx_np[j, :nh]
                hitab_np = hit_abunds_np[j, :, :nh]
                disc = discard_np[j]
            if emit_text:
                yield format_hits(rbatch, hits_np, hitab_np, disc)
            else:
                yield from decode_hits(rbatch, hits_np, hitab_np, disc)

    import os as _os
    import time as _time
    _timing = _os.environ.get('KEVLAR_COUNT_TIMING') == '1'
    _walls = {'parse': 0.0, 'dispatch': 0.0, 'collect': 0.0}

    def _timed_stream(stream):
        it = iter(stream)
        while True:
            t0 = _time.time()
            nxt = next(it, None)
            _walls['parse'] += _time.time() - t0
            if nxt is None:
                return
            yield nxt

    if _timing:
        batchstream = _timed_stream(batchstream)
        _dispatch0, _collect0 = dispatch_stack, collect

        def dispatch_stack(stack):
            t0 = _time.time()
            out = _dispatch0(stack)
            _walls['dispatch'] += _time.time() - t0
            return out

        def collect(entry):
            t0 = _time.time()
            out = list(_collect0(entry))
            _walls['collect'] += _time.time() - t0
            yield from out

    nskipped = 0
    for rbatch in batchstream:
        if skipping:
            # restartability support (novel.py:114-132): fast-forward to a
            # named read, host-side; the found read itself is also skipped
            # and the reported count includes it (reference novel.py:125-130)
            names = [r.name for r in rbatch.records]
            if skipuntil in names:
                idx = names.index(skipuntil)
                nskipped += idx + 1
                kevlar_tpu.plog(
                    '[kevlar::novel] Found read {:s} (skipped {:d} '
                    'reads)'.format(skipuntil, nskipped))
                rbatch.records = rbatch.records[idx + 1:]
                rbatch = batch_mod.ReadBatch(rbatch.records) \
                    if rbatch.records else None
                skipping = False
                if rbatch is None:
                    continue
            else:
                nskipped += len(names)
                continue
        nprocessed += len(rbatch)
        progress.update(len(rbatch))
        if hostsketch:
            if emit_text:
                yield from map(record_text, host_screen(rbatch))
            else:
                yield from host_screen(rbatch)
            continue
        if sharded:
            from kevlar_tpu.parallel import sharded_novel_screen
            interesting, abunds, discard, skip = sharded_novel_screen(
                casecounts[0].mesh, casecounts, controlcounts,
                rbatch.bases, rbatch.lengths, casemin=casemin,
                ctrlmax=ctrlmax, screen=abundscreen)
            flat = np.nonzero(np.asarray(interesting).ravel())[0]
            abunds_np = np.asarray(abunds).reshape(
                len(casecounts) + len(controlcounts), -1)
            if emit_text:
                yield format_hits(rbatch, flat, abunds_np[:, flat],
                                  np.asarray(discard))
            else:
                yield from decode_hits(rbatch, flat, abunds_np[:, flat],
                                       np.asarray(discard))
            continue
        if pending and pending[0].bases.shape != rbatch.bases.shape:
            inflight.append(dispatch_stack(pending))
            pending = []
        pending.append(rbatch)
        if len(pending) >= STACK_DEPTH:
            inflight.append(dispatch_stack(pending))
            pending = []
        while len(inflight) > MAX_INFLIGHT:
            yield from collect(inflight.popleft())
    if pending:
        inflight.append(dispatch_stack(pending))
    while inflight:
        yield from collect(inflight.popleft())

    elapsed = timer.stop()
    if _timing:
        kevlar_tpu.plog(
            '[kevlar::novel] timing: parse+marshal {parse:.1f}s, '
            'dispatch-enqueue {dispatch:.1f}s, collect(device+decode) '
            '{collect:.1f}s'.format(**_walls))
    message = 'Found {:d} instances of {:d} unique novel kmers in {:d} reads'
    message += ' in {:.2f} seconds'
    kevlar_tpu.plog('[kevlar::novel]', message.format(
        nkmers, len(unique_kmers), nreads, elapsed))


def main(args):
    timer = kevlar_tpu.Timer()
    timer.start()
    if (not args.num_bands) is not (not args.band):
        raise ValueError('Must specify --num-bands and --band together')
    myband = args.band - 1 if args.band else None
    mesh = None
    if getattr(args, 'shards', None):
        if args.num_bands:
            raise ValueError('banding and --shards are mutually exclusive: '
                             'hash-space sharding supersedes banding')
        from kevlar_tpu.parallel import make_mesh
        mesh = make_mesh(n_shard=args.shards)
        kevlar_tpu.plog('[kevlar::novel] sharding sample sketches over mesh',
                        dict(mesh.shape))

    kevlar_tpu.plog('[kevlar::novel] Loading control samples')
    controls = load_samples(
        args.control_counts, args.control, args.ksize, args.memory,
        args.max_fpr, args.num_bands, myband, args.threads,
        args.save_ctrl_counts, mesh=mesh)
    kevlar_tpu.plog('[kevlar::novel] Loading case samples')
    cases = load_samples(
        args.case_counts, args.case, args.ksize, args.memory,
        args.max_fpr, args.num_bands, myband, args.threads,
        args.save_case_counts, mesh=mesh)

    outstream = kevlar_tpu.open(args.out, 'w')
    infiles = [f for filelist in args.case for f in filelist]
    from kevlar_tpu import seqio
    caserecords = None
    batchstream = None
    if args.skip_until is None:
        try:  # native fast path: no per-read Python objects on the stream
            from kevlar_tpu import native
            if native.available():
                batchstream = native_read_batches(
                    infiles, batch_mod.DEFAULT_BATCH_SIZE)
        except ImportError:
            pass
    if batchstream is None:
        caserecords = seqio.multi_file_iter(infiles)
    textstream = novel(
        caserecords, cases, controls, ksize=args.ksize,
        abundscreen=args.abund_screen, casemin=args.case_min,
        ctrlmax=args.ctrl_max, numbands=args.num_bands, band=myband,
        skipuntil=args.skip_until, batchstream=batchstream, emit='text')
    for textblock in textstream:
        if textblock:
            outstream.write(textblock)

    total = timer.stop()
    kevlar_tpu.plog(
        '[kevlar::novel] Total time: {:.2f} seconds'.format(total))
