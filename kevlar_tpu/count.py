"""``count`` stage: stream reads into a device Count-Min sketch.

Parity with /root/reference/kevlar/count.py: per-sample k-mer counting with
optional mask (skip masked k-mers, or count *only* masked k-mers), optional
hash-space banding, khmer-style memory->tablesize sizing, FPR bailout, and
extension-typed sketch persistence.

Device design: reads are marshalled into padded [B, L] base batches
(:mod:`kevlar_tpu.batch`) and counted by one jitted scatter kernel per batch
— the thread-parallel ReadParser loop of the reference becomes a single
device program over batched reads.
"""

import kevlar_tpu
from kevlar_tpu import seqio
from kevlar_tpu.batch import batches_from_records, DEFAULT_BATCH_SIZE
from kevlar_tpu.sketch import (
    allocate_from_memory, estimate_fpr, get_extension, KevlarUnsuitableFPRError,
)


def _consume_seqfile_prefetch(sketch, seqfiles, mask, consume_masked,
                              threshold, batch_size, wing, stack_depth=8,
                              numbands=None, band=None):
    """Threaded producer/consumer consume: parse + 2-bit pack + H2D run
    one stack ahead of the device consume chain, so host marshalling and
    transfer hide behind device scatter time (the wall becomes
    max(device, host) instead of their sum).  Returns the read count, or
    None when the native parser is unavailable (caller falls back to the
    sequential Python loop).  Bit-identical to the sequential packed-wire
    path: same stack shapes, same consume program.
    """
    import os
    import queue
    import threading
    import time
    import numpy as np
    import jax
    from kevlar_tpu.batch import native_base_batches, pack_bases
    from kevlar_tpu.ops import sketch_ops
    from kevlar_tpu.sketch import _device_mask_tables

    try:
        from kevlar_tpu import native  # noqa: F401  (probe availability)
        native.FastxBatchReader
    except (ImportError, AttributeError):
        return None

    timing = os.environ.get('KEVLAR_COUNT_TIMING') == '1'
    walls = {'produce': 0.0, 'dispatch': 0.0, 'sync': 0.0}
    mask_tables = _device_mask_tables(mask)
    q = queue.Queue(maxsize=2)
    producer_error = []

    def marshal(entries):
        stack = [b for b, _ in entries]
        nreads = sum(n for _, n in entries)
        while len(stack) < stack_depth:  # pad: one compiled stack shape
            stack.append(np.full_like(stack[0], 4))
        stacked = np.stack(stack)
        packed, badmask = pack_bases(stacked)
        # ship from the producer thread: the transfer overlaps the
        # consume chain the main thread keeps dispatched
        return (jax.device_put(packed), jax.device_put(badmask),
                stacked.shape[-1], nreads)

    def produce():
        try:
            pending = {}
            for seqfile in seqfiles:
                for bases, lengths in native_base_batches(
                        seqfile, batch_size, overlap=wing):
                    t0 = time.time() if timing else 0
                    shape = bases.shape
                    lst = pending.setdefault(shape, [])
                    lst.append((np.asarray(bases), len(lengths)))
                    if len(lst) >= stack_depth:
                        item = marshal(pending.pop(shape))
                        if timing:
                            walls['produce'] += time.time() - t0
                        q.put(item)
                    elif timing:
                        walls['produce'] += time.time() - t0
            for shape in list(pending):
                q.put(marshal(pending.pop(shape)))
        except BaseException as exc:  # surfaced on the main thread
            producer_error.append(exc)
        finally:
            q.put(None)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    numreads = 0
    while True:
        item = q.get()
        if item is None:
            break
        packed, badmask, L, nreads = item
        t0 = time.time() if timing else 0
        sketch.tables = sketch_ops.consume_batch_stack_packed(
            sketch.tables, packed, badmask, L=L,
            ksize=sketch.ksize(), maxcount=sketch.maxcount,
            numbands=numbands, band=band,
            counter_bits=sketch.counter_bits,
            tablesize=sketch.tablesize,
            mask_tables=mask_tables, has_mask=mask is not None,
            mask_threshold=threshold, consume_masked=consume_masked,
            mask_bits=mask.counter_bits if mask is not None else 8,
            mask_tablesize=mask.tablesize if mask is not None else None)
        sketch._invalidate()
        if timing:
            walls['dispatch'] += time.time() - t0
        numreads += nreads
    thread.join()
    if producer_error:
        if isinstance(producer_error[0], ImportError) and numreads == 0:
            return None  # native parser unavailable: sequential fallback
        raise producer_error[0]
    if timing:
        t0 = time.time()
        jax.block_until_ready(sketch.tables)
        walls['sync'] = time.time() - t0
        kevlar_tpu.plog(
            '[kevlar::count] timing (prefetch): produce(parse+pack+H2D, '
            'overlapped) {produce:.1f}s, dispatch-blocked {dispatch:.1f}s, '
            'final sync {sync:.1f}s'.format(**walls))
    return numreads


def consume_seqfile(sketch, seqfiles, mask=None, consume_masked=False,
                    maskmaxabund=0, numbands=None, band=None,
                    batch_size=DEFAULT_BATCH_SIZE):
    """Count all k-mers in the given FASTA/FASTQ files into `sketch`.

    Uses the native C++ batch parser when built (reads marshalled straight
    into padded device batches); falls back to the Python parser.
    """
    import os
    import time
    import numpy as np
    from kevlar_tpu.batch import chunk_long_records, native_base_batches
    numreads = 0
    wing = sketch.ksize() - 1  # chunk genome-scale records losslessly
    threshold = 1 if consume_masked else maskmaxabund
    stack_depth = 8
    pending = {}

    from kevlar_tpu.sketch import Sketch as _Sketch
    mask_ok = mask is None or (isinstance(mask, _Sketch)
                               and mask.backend == 'device')
    packed_wire = (getattr(sketch, 'backend', 'device') == 'device'
                   and hasattr(sketch, 'consume_batch_stack')
                   and mask_ok
                   and os.environ.get('KEVLAR_PACKED_WIRE', '1') != '0')
    if packed_wire and os.environ.get('KEVLAR_PREFETCH', '1') != '0':
        # overlapped pipeline: a producer thread parses, packs, and ships
        # batches to the device while this thread keeps the consume chain
        # dispatched — the reference hides parse latency the same way with
        # khmer's threaded ReadParser (SURVEY §3.1)
        done = _consume_seqfile_prefetch(
            sketch, seqfiles, mask=mask, consume_masked=consume_masked,
            threshold=threshold, batch_size=batch_size, wing=wing,
            stack_depth=stack_depth, numbands=numbands, band=band)
        if done is not None:
            return done
    # KEVLAR_COUNT_TIMING=1: decompose the stage wall into host parse/
    # marshal time vs time blocked inside dispatch calls (async device
    # work overlaps the parse; blocking here means the dispatch queue or
    # an H2D transfer is the limiter) vs the final chain sync
    timing = os.environ.get('KEVLAR_COUNT_TIMING') == '1'
    walls = {'parse': 0.0, 'dispatch': 0.0, 'sync': 0.0}

    def flush(shape):
        stack = pending.pop(shape)
        if not stack:
            return
        if hasattr(sketch, 'consume_batch_stack') and len(stack) > 1:
            while len(stack) < stack_depth:  # pad: one compiled stack shape
                stack.append(np.full_like(stack[0], 4))
            stacked = np.stack(stack)
            import os
            from kevlar_tpu.sketch import Sketch, _device_mask_tables
            mask_ok = mask is None or (isinstance(mask, Sketch)
                                       and mask.backend == 'device')
            if getattr(sketch, 'backend', 'device') == 'device' \
                    and mask_ok \
                    and os.environ.get('KEVLAR_PACKED_WIRE', '1') != '0':
                # 2-bit wire format: 3.7x less host->device traffic
                # (default on; bit-identical — set KEVLAR_PACKED_WIRE=0
                # to send raw base codes); masked
                # counting screens against the mask tables on-device
                from kevlar_tpu.batch import pack_bases
                from kevlar_tpu.ops import sketch_ops
                packed, badmask = pack_bases(stacked)
                sketch.tables = sketch_ops.consume_batch_stack_packed(
                    sketch.tables, packed, badmask, L=stacked.shape[-1],
                    ksize=sketch.ksize(), maxcount=sketch.maxcount,
                    numbands=numbands, band=band,
                    counter_bits=sketch.counter_bits,
                    tablesize=sketch.tablesize,
                    mask_tables=_device_mask_tables(mask),
                    has_mask=mask is not None,
                    mask_threshold=threshold, consume_masked=consume_masked,
                    mask_bits=mask.counter_bits if mask is not None else 8,
                    mask_tablesize=(mask.tablesize if mask is not None
                                    else None))
                sketch._invalidate()
            else:
                sketch.consume_batch_stack(
                    stacked, numbands=numbands, band=band, mask=mask,
                    mask_threshold=threshold, consume_masked=consume_masked)
        else:
            for bases in stack:
                sketch.consume_batch(
                    bases, numbands=numbands, band=band, mask=mask,
                    mask_threshold=threshold, consume_masked=consume_masked)

    def consume(bases, nreads):
        nonlocal numreads
        numreads += nreads
        shape = bases.shape
        pending.setdefault(shape, []).append(np.asarray(bases))
        if len(pending[shape]) >= stack_depth:
            t0 = time.time() if timing else 0
            flush(shape)
            if timing:
                walls['dispatch'] += time.time() - t0

    for seqfile in seqfiles:
        try:
            it = native_base_batches(seqfile, batch_size, overlap=wing)
            while True:
                t0 = time.time() if timing else 0
                nxt = next(it, None)
                if timing:
                    walls['parse'] += time.time() - t0
                if nxt is None:
                    break
                consume(nxt[0], len(nxt[1]))
        except ImportError:
            stream = chunk_long_records(
                seqio.multi_file_iter([seqfile]), overlap=wing)
            for batch in batches_from_records(stream, batch_size=batch_size):
                consume(batch.bases, len(batch))
    for shape in list(pending):
        flush(shape)
    if timing:
        t0 = time.time()
        if hasattr(sketch, 'tables'):
            import jax
            jax.block_until_ready(sketch.tables)
        walls['sync'] = time.time() - t0
        kevlar_tpu.plog(
            '[kevlar::count] timing: parse+marshal {parse:.1f}s, '
            'dispatch-blocked {dispatch:.1f}s, final sync '
            '{sync:.1f}s'.format(**walls))
    return numreads


def load_sample_seqfile(seqfiles, ksize, memory, maxfpr=0.2, count=True,
                        smallcount=False, mask=None, maskmaxabund=0,
                        consume_masked=False, numbands=None, band=None,
                        outfile=None, numthreads=1,
                        batch_size=DEFAULT_BATCH_SIZE, mesh=None,
                        sketch_format='native', save_async=False):
    """Compute k-mer abundances for one sample; returns the sketch.

    With `mesh`, the sketch is hash-sharded across the mesh's 'shard' axis
    and reads are data-parallel across 'data' (see docs/sharding.md);
    banding flags are then unnecessary and unsupported.

    ``sketch_format='khmer'`` counts on the khmer-binary-compatible host
    engine instead: the saved file is byte-identical to what khmer itself
    produces for the same input (incl. hash-range banding), so sketches
    are interchangeable with the reference implementation.  The native
    format (device-backed, npz) is the default.
    """
    counter_bits = (4 if smallcount else 8) if count else 1
    from kevlar_tpu.oxli import OxliSketch
    if sketch_format != 'khmer' and isinstance(mask, OxliSketch) \
            and mesh is None:
        # a khmer-format mask lives in khmer's hash space; the whole count
        # joins it there (the saved sketch is then khmer-format too, which
        # every downstream stage loads transparently)
        kevlar_tpu.plog('[kevlar::count] mask is khmer-format; counting on '
                        'the khmer-compatible host engine')
        sketch_format = 'khmer'
    if sketch_format == 'khmer':
        if mesh is not None:
            raise ValueError('--shards and --sketch-format khmer are '
                             'mutually exclusive')
        return _load_sample_seqfile_khmer(
            seqfiles, ksize, memory, maxfpr, counter_bits, mask,
            consume_masked, maskmaxabund, numbands, band, outfile,
            count=count, smallcount=smallcount)
    if mesh is not None:
        from kevlar_tpu.parallel import ShardedSketch
        from kevlar_tpu.sketch import BUCKETS_PER_BYTE
        tablesize = int(memory) // 4 * BUCKETS_PER_BYTE[counter_bits]
        if tablesize % 2 == 0:
            tablesize -= 1  # odd, matching allocate_from_memory (banding)
        # exact hash space: abundances (and the saved counttable) are
        # bit-identical to the unsharded stage at the same --memory
        sketch = ShardedSketch(mesh, ksize, max(tablesize, 1), 4,
                               counter_bits=counter_bits, exact=True)
    else:
        sketch = allocate_from_memory(ksize, memory, num_tables=4,
                                      counter_bits=counter_bits)
    numreads = 0
    for seqfile in seqfiles:
        kevlar_tpu.plog('[kevlar::count] - processing "{}"'.format(seqfile))
        numreads += consume_seqfile(
            sketch, [seqfile], mask=mask, consume_masked=consume_masked,
            maskmaxabund=maskmaxabund, numbands=numbands, band=band,
            batch_size=batch_size)

    message = 'Done loading k-mers'
    if numbands:
        message += ' (band {:d}/{:d})'.format(band + 1, numbands)
    fpr = estimate_fpr(sketch)
    message += ';\n    {:d} reads processed'.format(numreads)
    message += ', ~{:d} distinct k-mers stored'.format(
        sketch.n_unique_kmers())
    message += ';\n    estimated false positive rate is {:1.3f}'.format(fpr)
    if fpr > maxfpr:
        message += ' (FPR too high, bailing out!!!)'
        raise KevlarUnsuitableFPRError('[kevlar::count] ' + message)

    if outfile:
        extensions = get_extension(count=count, smallcount=smallcount)
        if not outfile.endswith(extensions):
            outfile += extensions[1]
        if save_async:
            # checkpoint write off the critical path: the device->host
            # mirror + npz write overlap the next stage's compute (the
            # device tables are immutable once counted).  Caller joins
            # the returned sketch._save_thread before relying on the file.
            import threading
            thread = threading.Thread(target=sketch.save, args=(outfile,),
                                      name='kevlar-save')
            thread.start()
            sketch._save_thread = thread
        else:
            sketch.save(outfile)
        from kevlar_tpu.sketch import register_saved
        register_saved(outfile, sketch)
        message += ';\n    saved to "{:s}"'.format(outfile)
    kevlar_tpu.plog('[kevlar::count]', message)
    return sketch


def _load_sample_seqfile_khmer(seqfiles, ksize, memory, maxfpr, counter_bits,
                               mask, consume_masked, maskmaxabund, numbands,
                               band, outfile, count=True, smallcount=False):
    """khmer-format counting path: byte-compatible tables + save files."""
    from kevlar_tpu.oxli import OxliSketch
    from kevlar_tpu.sketch import BUCKETS_PER_BYTE
    if mask is not None and not isinstance(mask, OxliSketch):
        raise ValueError(
            '--sketch-format khmer requires a khmer-format mask '
            '(.nt/.nodetable file); got a native-format sketch')
    tablesize = int(memory) // 4 * BUCKETS_PER_BYTE[counter_bits]
    sketch = OxliSketch(ksize, max(tablesize, 1), 4,
                        counter_bits=counter_bits)
    threshold = (maskmaxabund + 1) if (mask is not None and maskmaxabund)\
        else 1
    numreads = 0
    for seqfile in seqfiles:
        kevlar_tpu.plog('[kevlar::count] - processing "{}"'.format(seqfile))
        nr, _ = sketch.consume_seqfile(
            seqfile, mask=mask, threshold=threshold,
            consume_masked=consume_masked, numbands=numbands, band=band)
        numreads += nr

    message = 'Done loading k-mers'
    if numbands:
        message += ' (band {:d}/{:d})'.format(band + 1, numbands)
    fpr = estimate_fpr(sketch)
    message += ';\n    {:d} reads processed'.format(numreads)
    # exact (khmer-tracked) distinct-k-mer count, matching the reference's
    # "N distinct k-mers stored" log line
    message += ', {:d} distinct k-mers stored'.format(
        sketch.n_unique_kmers())
    message += ';\n    estimated false positive rate is {:1.3f}'.format(fpr)
    if fpr > maxfpr:
        message += ' (FPR too high, bailing out!!!)'
        raise KevlarUnsuitableFPRError('[kevlar::count] ' + message)
    if outfile:
        extensions = get_extension(count=count, smallcount=smallcount)
        if not outfile.endswith(extensions):
            outfile += extensions[1]
        sketch.save(outfile)
        from kevlar_tpu.sketch import register_saved
        register_saved(outfile, sketch)
        message += ';\n    saved to "{:s}"'.format(outfile)
    kevlar_tpu.plog('[kevlar::count]', message)
    return sketch


def print_config(args):
    tabletypes = {1: 'node', 4: 'small count', 8: 'count'}
    maxcounts = {1: 1, 4: 15, 8: 255}
    message = 'Storing k-mers in a {} table'.format(
        tabletypes[args.counter_size])
    if args.counter_size == 1:
        message += ' (Bloom filter) for k-mer presence/absence queries'
    else:
        message += ', a CountMin sketch with a counter size of {} bits'.format(
            args.counter_size)
        message += ', for k-mer abundance queries (max abundance {})'.format(
            maxcounts[args.counter_size])
    kevlar_tpu.plog('[kevlar::count]', message)


def main(args):
    if (args.num_bands is None) is not (args.band is None):
        raise ValueError('Must specify --num-bands and --band together')
    myband = args.band - 1 if args.band else None
    mesh = None
    if getattr(args, 'shards', None):
        if args.num_bands:
            raise ValueError('banding and --shards are mutually exclusive: '
                             'hash-space sharding supersedes banding')
        from kevlar_tpu.parallel import make_mesh
        mesh = make_mesh(n_shard=args.shards)
        kevlar_tpu.plog('[kevlar::count] sharding the sketch over mesh',
                        dict(mesh.shape))
    mask = None
    if args.mask:
        from kevlar_tpu import sketch as sketch_mod
        mask = sketch_mod.load(args.mask)
        if mesh is not None:
            from kevlar_tpu.parallel import ShardedSketch
            mask = ShardedSketch.from_sketch(mesh, mask)
    print_config(args)

    timer = kevlar_tpu.Timer()
    timer.start()
    docount = args.counter_size > 1
    dosmallcount = args.counter_size == 4
    load_sample_seqfile(
        args.seqfile, args.ksize, args.memory, args.max_fpr, count=docount,
        smallcount=dosmallcount, mask=mask,
        consume_masked=args.count_masked, numbands=args.num_bands, band=myband,
        numthreads=args.threads, outfile=args.counttable, mesh=mesh,
        sketch_format=getattr(args, 'sketch_format', 'native'))
    total = timer.stop()
    kevlar_tpu.plog(
        '[kevlar::count] Total time: {:.2f} seconds'.format(total))
