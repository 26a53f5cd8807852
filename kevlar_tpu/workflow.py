"""End-to-end trio workflow driver: the mark-I pipeline without Snakemake.

The reference orchestrates the full simplex workflow as a Snakemake DAG of
CLI invocations communicating through files
(/root/reference/kevlar/workflows/mark-I/Snakefile: create_mask ->
count_reference -> count case/controls (masked) -> novel -> filter ->
partition -> split -> assemble xN -> localize -> call xN -> varfilter ->
simlike).  Here the same pipeline runs as one in-process driver — no
process-per-stage, one JAX runtime, scatter/gather handled by batching
instead of file shards.  Stage outputs are still written to the working
directory as resumable checkpoints (sketches, augfastx, VCF), matching the
reference's checkpoint/resume model (SURVEY.md §5).

Config (JSON) mirrors the reference's mark-I config.json vocabulary::

    {
      "ksize": 31,
      "outdir": "out",
      "reference": {"fasta": "refr.fa"},
      "contaminants": {"fasta": null},
      "case": {"fastx": ["proband.fq"], "label": "Case", "memory": "8M",
               "max_fpr": 0.6},
      "controls": [
        {"fastx": ["mother.fq"], "label": "Mother", "memory": "8M",
         "max_fpr": 0.05},
        {"fastx": ["father.fq"], "label": "Father", "memory": "8M",
         "max_fpr": 0.05}
      ],
      "mask": {"memory": "4M", "max_fpr": 0.01},
      "novel": {"case_min": 6, "ctrl_max": 1},
      "localize": {"seed_size": 51, "delta": 50, "blind": false},
      "varfilter": null,
      "simlike": {"mu": 30.0, "sigma": 8.0, "epsilon": 0.001}
    }
"""

import json
import os

import kevlar_tpu
from kevlar_tpu.cli import memory_setting


def _malloc_trim():
    """Return freed glibc arenas to the OS at stage boundaries.

    Each stage's multi-hundred-MB transfer/save buffers are freed
    promptly, but glibc's dynamically raised mmap threshold keeps the
    arenas resident — measured ~300-500 MB of RSS creep per workflow
    stage (peak 4.8 GB on the quick-start trio) that a trim releases."""
    try:
        import ctypes
        ctypes.CDLL('libc.so.6').malloc_trim(0)
    except Exception:
        pass


def _mem(value, default):
    if value is None:
        return default
    return memory_setting(value)


def run_mark1(config, logstream=None):
    """Run the full trio workflow; returns the final VCF path."""
    from kevlar_tpu import count as count_mod
    from kevlar_tpu import novel as novel_mod
    from kevlar_tpu import filter as filter_mod
    from kevlar_tpu import partition as partition_mod
    from kevlar_tpu import alac as alac_mod
    from kevlar_tpu import varfilter as varfilter_mod
    from kevlar_tpu import simlike as simlike_mod
    from kevlar_tpu import seqio, sketch as sketch_mod, vcf as vcf_mod

    ksize = config.get('ksize', 31)
    outdir = config.get('outdir', '.')
    os.makedirs(outdir, exist_ok=True)

    def path(name):
        return os.path.join(outdir, name)

    kevlar_tpu.plog('[workflow]', kevlar_tpu.device_banner())
    timer = kevlar_tpu.Timer()
    timer.start()

    # -- step 0: reference mask (1-bit) + reference counts (4-bit) --------
    refrfile = config['reference']['fasta']
    stage_marks = []
    # per-stage jax.profiler spans (SURVEY §5): with the 'profile' config
    # key (a trace directory) every stage appears as a named TraceAnnotation
    # in the captured trace, so device time attributes to pipeline stages
    profile_dir = config.get('profile')
    _span = [None]
    if profile_dir:
        import jax
        jax.profiler.start_trace(profile_dir)
        kevlar_tpu.plog('[workflow] profiler trace ->', profile_dir)

    def _close_span():
        if _span[0] is not None:
            _span[0].__exit__(None, None, None)
            _span[0] = None

    def _stage(msg):
        stage_marks.append((msg, timer.probe()))
        if profile_dir:
            import jax
            _close_span()
            _span[0] = jax.profiler.TraceAnnotation('workflow::' + msg)
            _span[0].__enter__()
        _malloc_trim()
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        kevlar_tpu.plog('[workflow] ({:.1f}s, rss {:.0f} MB) {}'.format(
            timer.probe(), rss, msg))
    _stage('creating reference mask')
    maskmem = _mem(config.get('mask', {}).get('memory'), 4e6)
    maskfiles = [refrfile]
    contam = config.get('contaminants') or {}
    if contam.get('fasta'):
        maskfiles.append(contam['fasta'])
    mask = count_mod.load_sample_seqfile(
        maskfiles, ksize, maskmem,
        maxfpr=config.get('mask', {}).get('max_fpr', 0.01),
        count=False, outfile=path('mask.nt'), save_async=True)

    _stage('counting reference genome k-mers')
    refr_counts = count_mod.load_sample_seqfile(
        [refrfile], ksize, maskmem, maxfpr=1.0, count=True, smallcount=True,
        outfile=path('refr.sct'), save_async=True)

    # -- step 1: per-sample masked counting -------------------------------
    # config key 'shards': hash-shard every sample sketch across that many
    # mesh devices and run counting + the novel screen as SPMD programs
    # (supersedes the reference's banding workflow; docs/sharding.md)
    mesh = None
    sample_mask = mask
    if config.get('shards'):
        from kevlar_tpu.parallel import ShardedSketch, make_mesh
        mesh = make_mesh(n_shard=int(config['shards']))
        _stage('sharding sketches over mesh {}'.format(dict(mesh.shape)))
        sample_mask = ShardedSketch.from_sketch(mesh, mask)
    case_cfg = config['case']
    ctrl_cfgs = config.get('controls', [])
    _stage('counting case sample')
    case_counts = count_mod.load_sample_seqfile(
        case_cfg['fastx'], ksize, _mem(case_cfg.get('memory'), 1e6),
        maxfpr=case_cfg.get('max_fpr', 0.6), mask=sample_mask,
        outfile=path('case.ct'), mesh=mesh, save_async=True)
    ctrl_counts = []
    for i, ctrl in enumerate(ctrl_cfgs):
        _stage('counting control sample {}'.format(i))
        ctrl_counts.append(count_mod.load_sample_seqfile(
            ctrl['fastx'], ksize, _mem(ctrl.get('memory'), 1e6),
            maxfpr=ctrl.get('max_fpr', 0.05), mask=sample_mask,
            outfile=path('control{}.ct'.format(i)), mesh=mesh,
            save_async=True))

    # -- step 2: novel k-mer screen ---------------------------------------
    _stage('novel k-mer screen')
    novel_cfg = config.get('novel', {})
    casemin = novel_cfg.get('case_min', 6)
    ctrlmax = novel_cfg.get('ctrl_max', 1)
    caserecords = None
    batchstream = None
    try:  # native fast path: no per-read Python objects on the stream
        from kevlar_tpu import native
        from kevlar_tpu.batch import DEFAULT_BATCH_SIZE
        if native.available():
            batchstream = novel_mod.native_read_batches(
                case_cfg['fastx'], DEFAULT_BATCH_SIZE)
    except ImportError:
        pass
    if batchstream is None:
        caserecords = seqio.multi_file_iter(case_cfg['fastx'])
    novelfile = path('novel.augfastq.gz')
    with kevlar_tpu.open(novelfile, 'w') as fh:
        for textblock in novel_mod.novel(caserecords, [case_counts],
                                         ctrl_counts, ksize=ksize,
                                         casemin=casemin, ctrlmax=ctrlmax,
                                         batchstream=batchstream,
                                         emit='text'):
            if textblock:
                fh.write(textblock)

    # -- step 3: filter (recount against the reference mask) --------------
    _stage('filtering novel reads')
    filteredfile = path('filtered.augfastq.gz')
    with kevlar_tpu.open(filteredfile, 'w') as fh:
        for record in filter_mod.filter(novelfile, mask=mask,
                                        casemin=casemin, ctrlmax=ctrlmax):
            kevlar_tpu.print_augmented_fastx(record, fh)

    # -- step 4: partition -------------------------------------------------
    _stage('partitioning reads')
    reader = kevlar_tpu.parse_augmented_fastx(
        kevlar_tpu.open(filteredfile, 'r'))
    partfile = path('partitioned.augfastq.gz')
    pstream = partition_mod.partition(reader, minabund=2, maxabund=200)
    with kevlar_tpu.open(partfile, 'w') as fh:
        for partid, reads in pstream:
            for read in reads:
                kevlar_tpu.print_augmented_fastx(read, fh)

    # -- step 5: assemble + localize + call (fused) ------------------------
    _stage('assemble/localize/align/call')
    loc = config.get('localize', {})
    reader = kevlar_tpu.parse_augmented_fastx(kevlar_tpu.open(partfile, 'r'))
    pstream = seqio.parse_partitioned_reads(reader)
    prelimfile = path('calls.prelim.vcf')
    calls = alac_mod.alac(
        pstream, refrfile, ksize=ksize, threads=config.get('threads', 1),
        seedsize=loc.get('seed_size', 51), delta=loc.get('delta', 50),
        maskfile=path('callmask.nt'))
    with kevlar_tpu.open(prelimfile, 'w') as fh:
        writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow',
                                   refr=refrfile)
        writer.write_header()
        for call in calls:
            writer.write(call)

    # -- step 6: optional varfilter ----------------------------------------
    vcf_for_scoring = prelimfile
    if config.get('varfilter'):
        _stage('applying user region filter')
        filtvcf = path('calls.filtered.vcf')
        reader = vcf_mod.vcfstream([prelimfile])
        beds = kevlar_tpu.parse_bed(
            kevlar_tpu.open(config['varfilter'], 'r'))
        with kevlar_tpu.open(filtvcf, 'w') as fh:
            writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow')
            writer.write_header()
            for call in varfilter_mod.varfilter(reader, beds):
                writer.write(call)
        vcf_for_scoring = filtvcf

    # -- step 7: likelihood scoring ----------------------------------------
    _stage('scoring calls (simlike)')
    sim = config.get('simlike', {})
    labels = [case_cfg.get('label', 'Case')] + \
        [c.get('label', 'Control{}'.format(i))
         for i, c in enumerate(ctrl_cfgs)]
    # score from the on-disk checkpoints as host-backend mmaps (still in
    # the page cache): the live device sketches would answer the few
    # thousand point queries by pulling full-table host mirrors back over
    # the wire.  Sharded (mesh) sketches stay device-resident — their
    # queries are SPMD programs.
    from kevlar_tpu import sketch as sketch_mod
    if mesh is None:
        for sk in [case_counts, refr_counts] + ctrl_counts:
            thread = getattr(sk, '_save_thread', None)
            if thread is not None:
                thread.join()
                sk._save_thread = None
        sl_case = sketch_mod.load(path('case.ct'), backend='host',
                                  cache=False)
        sl_ctrls = [sketch_mod.load(path('control{}.ct'.format(i)),
                                    backend='host', cache=False)
                    for i in range(len(ctrl_counts))]
        sl_refr = sketch_mod.load(path('refr.sct'), backend='host',
                                  cache=False)
    else:
        sl_case, sl_ctrls, sl_refr = case_counts, ctrl_counts, refr_counts
    finalfile = path('calls.scored.sorted.vcf.gz')
    reader = vcf_mod.vcfstream([vcf_for_scoring])
    with kevlar_tpu.open(finalfile, 'w') as fh:
        writer = vcf_mod.VCFWriter(fh, source='kevlar_tpu::workflow')
        for label in labels:
            writer.register_sample(label)
        writer.write_header()
        for call in simlike_mod.simlike(
                reader, sl_case, sl_ctrls, sl_refr,
                mu=sim.get('mu', 30.0), sigma=sim.get('sigma', 8.0),
                epsilon=sim.get('epsilon', 0.001), casemin=casemin,
                ctrlmax=ctrlmax, samplelabels=labels):
            writer.write(call)

    # join the async checkpoint writers before declaring the run complete
    for sk in [mask, refr_counts, case_counts] + ctrl_counts:
        thread = getattr(sk, '_save_thread', None)
        if thread is not None:
            thread.join()

    total = timer.stop()
    kevlar_tpu.plog('[workflow] complete in {:.1f}s; final calls in'.format(
        total), finalfile)
    stage_marks.append(('done', timer.probe()))
    if profile_dir:
        import jax
        _close_span()
        jax.profiler.stop_trace()
    # per-stage wall deltas, exposed for benchmarking
    run_mark1.last_stage_times = [
        (label, round(stage_marks[i + 1][1] - t, 2))
        for i, (label, t) in enumerate(stage_marks[:-1])]
    return finalfile


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description='Run the full kevlar-tpu trio workflow from a JSON '
        'config (the mark-I pipeline).')
    parser.add_argument('config', help='JSON workflow configuration')
    args = parser.parse_args(argv)
    with open(args.config) as fh:
        config = json.load(fh)
    run_mark1(config)


if __name__ == '__main__':
    main()
