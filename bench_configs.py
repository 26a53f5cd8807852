"""BASELINE.md benchmark configs 2-5, timed on the default backend.

Config 1 (count+novel reads/s) is ``bench.py`` — the driver's primary
metric.  This script covers the remaining BASELINE benchmark configs as
timed CLI-stage runs over one simulated trio:

  2. novel -> filter -> partition
  3. partition stream -> assemble -> localize
  4. full SNV/indel calling to VCF (call + simlike), plus the whole
     trio -> VCF wall and an accuracy guard against the gentrio truth
  5. hash-sharded sketch mode: count+novel through the mesh-sharded
     sketch path (--shards), sized to the attached device count

Each stage is driven exactly the way a user drives it (parse_args +
stage main), so the timings include each stage's real host/device split.
Writes ``BENCH_CONFIGS.json`` next to this script and prints one JSON
line per config.

Usage:  python bench_configs.py [--genome-size N] [--coverage C]
        [--error E] [--workdir DIR] [--keep]
(default JAX backend; KEVLAR_PLATFORM=cpu for the host backend)
"""

import argparse
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, 'tools'))

from sim_trio_bench import denovo_truth, simulate_reads  # noqa: E402


def timed_stage(arglist):
    """Run one CLI stage in-process; returns wall seconds."""
    import kevlar_tpu.cli as cli
    from kevlar_tpu import (alac, assemble, call, count, filter as filter_mod,
                            gentrio, localize, novel, partition, simlike)
    mains = {'count': count.main, 'novel': novel.main,
             'filter': filter_mod.main, 'partition': partition.main,
             'assemble': assemble.main, 'localize': localize.main,
             'call': call.main, 'simlike': simlike.main,
             'gentrio': gentrio.main, 'alac': alac.main}
    args = cli.parse_args([str(a) for a in arglist])
    t0 = time.time()
    mains[arglist[0]](args)
    return time.time() - t0


def count_fastx_records(path, marker):
    n = 0
    with open(path) as fh:
        for line in fh:
            if line.startswith(marker):
                n += 1
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--genome-size', type=int, default=400_000)
    ap.add_argument('--coverage', type=int, default=30)
    ap.add_argument('--error', type=float, default=0.005)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--seed', type=int, default=20260819)
    ap.add_argument('--case-min', type=int, default=5)
    ap.add_argument('--memory', default='32M')
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--keep', action='store_true')
    args = ap.parse_args()

    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_cfgbench_')
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    print('# workdir:', workdir, file=sys.stderr)

    import kevlar_tpu  # noqa: F401 -- applies KEVLAR_PLATFORM before jax use
    import jax
    backend = jax.default_backend()
    n_devices = jax.device_count()

    rng = random.Random(args.seed)
    results = []

    def emit(entry):
        results.append(entry)
        print(json.dumps(entry), flush=True)

    # ------------------------------------------------------- setup (untimed)
    with open('genome.fa', 'w') as fh:
        fh.write('>chr1\n')
        g = ''.join(rng.choice('ACGT') for _ in range(args.genome_size))
        for i in range(0, len(g), 80):
            fh.write(g[i:i + 80] + '\n')
    timed_stage(['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
                 '--inherited', 8, '--de-novo', 8, '--seed', args.seed,
                 'genome.fa'])
    nreads = {}
    for who in ('proband', 'mother', 'father'):
        nreads[who] = simulate_reads('trio-{}.fasta'.format(who),
                                     who + '.fq', args.coverage,
                                     args.readlen, args.error,
                                     rng.randrange(1 << 30))
    total_reads = sum(nreads.values())
    print('# reads per sample:', nreads, file=sys.stderr)

    # counting (input prep for config 2; reported for context)
    t_count = {}
    for who, fpr in (('proband', 0.6), ('mother', 0.3), ('father', 0.3)):
        t_count[who] = timed_stage(
            ['count', '-k', 31, '-M', args.memory, '--max-fpr', fpr,
             who + '.ct', who + '.fq'])
    emit({'config': 0, 'metric': 'count_3_samples_wall_s',
          'value': round(sum(t_count.values()), 2), 'unit': 's',
          'backend': backend, 'detail': {
              'genome_size': args.genome_size, 'coverage': args.coverage,
              'error_rate': args.error, 'total_reads': total_reads,
              'per_sample_s': {k: round(v, 2) for k, v in t_count.items()}}})

    # --------------------------------- config 2: novel -> filter -> partition
    novel_args = ['novel', '-k', 31, '--case', 'proband.fq',
                  '--case-counts', 'proband.ct',
                  '--control-counts', 'mother.ct', 'father.ct',
                  '--ctrl-max', 1, '--case-min', args.case_min,
                  '--out', 'novel.augfastq']
    t_novel = timed_stage(novel_args)
    # steady-state: the in-process jit cache is warm now, so a second run
    # times the stage without the one-off compile latency
    t_novel_steady = timed_stage(novel_args)
    t_filter = timed_stage(
        ['filter', '-M', args.memory, '--max-fpr', 0.05,
         '--case-min', args.case_min,
         '--out', 'filtered.augfastq', 'novel.augfastq'])
    t_partition = timed_stage(
        ['partition', '--out', 'partitioned.augfastq', 'filtered.augfastq'])
    wall2 = t_novel + t_filter + t_partition
    emit({'config': 2, 'metric': 'novel_filter_partition_wall_s',
          'value': round(wall2, 2), 'unit': 's', 'backend': backend,
          'detail': {'novel_s': round(t_novel, 2),
                     'novel_steady_s': round(t_novel_steady, 2),
                     'filter_s': round(t_filter, 2),
                     'partition_s': round(t_partition, 2),
                     'screened_reads': nreads['proband'],
                     'novel_reads_per_s': round(nreads['proband'] / wall2),
                     'novel_reads_per_s_steady': round(
                         nreads['proband'] / t_novel_steady)}})

    # ----------------------------- config 3: assemble -> localize (contigs/s)
    t_assemble = timed_stage(
        ['assemble', '--out', 'contigs.augfasta', 'partitioned.augfastq'])
    n_contigs = count_fastx_records('contigs.augfasta', '>')
    t_localize = timed_stage(
        ['localize', '--out', 'cutouts.fa', '--seed-size', 51,
         '--delta', 50, 'genome.fa', 'contigs.augfasta'])
    n_cutouts = count_fastx_records('cutouts.fa', '>')
    emit({'config': 3, 'metric': 'assemble_localize_wall_s',
          'value': round(t_assemble + t_localize, 2), 'unit': 's',
          'backend': backend, 'detail': {
              'assemble_s': round(t_assemble, 2),
              'localize_s': round(t_localize, 2),
              'contigs': n_contigs, 'cutouts': n_cutouts,
              'assemble_contigs_per_s': round(n_contigs / t_assemble, 1)}})

    # -------------------------- config 4: full calling to VCF (call+simlike)
    call_args = ['call', '--out', 'calls.vcf', '-k', 31,
                 '--refr', 'genome.fa', 'contigs.augfasta', 'cutouts.fa']
    t_call = timed_stage(call_args)
    t_call_steady = timed_stage(call_args)
    t_refrcount = timed_stage(
        ['count', '-k', 31, '-c', 4, '-M', args.memory, '--max-fpr', 0.5,
         'refr.sct', 'genome.fa'])
    t_simlike = timed_stage(
        ['simlike', '--case', 'proband.ct',
         '--controls', 'mother.ct', 'father.ct', '--refr', 'refr.sct',
         '--case-min', args.case_min,
         '--mu', args.coverage, '--sigma', args.coverage * 0.3,
         '--out', 'scored.vcf', 'calls.vcf'])

    truth = denovo_truth('truth.vcf')

    def load_calls(path, pass_only):
        rows = []
        with open(path) as fh:
            for line in fh:
                if line.startswith('#'):
                    continue
                f = line.split('\t')
                if pass_only and f[6] != 'PASS':
                    continue
                rows.append((int(f[1]) - 1, f[3], f[4]))
        return rows

    def recall(rows):
        return sum(
            any(abs(cp - pos) <= 10 and
                (len(cr) - len(ca)) == (len(r) - len(a))
                for cp, cr, ca in rows)
            for pos, r, a in truth)

    calls = load_calls('scored.vcf', pass_only=True)
    found = recall(calls)
    called = recall(load_calls('calls.vcf', pass_only=False))
    align_engine = ('device' if backend != 'cpu' else
                    os.environ.get('KEVLAR_ALIGN_BACKEND', 'native'))
    wall_to_vcf = (sum(t_count.values()) + wall2 + t_assemble + t_localize +
                   t_call + t_simlike)
    emit({'config': 4, 'metric': 'full_calling_wall_s',
          'value': round(t_call + t_simlike, 2), 'unit': 's',
          'backend': backend, 'detail': {
              'call_s': round(t_call, 2),
              'call_steady_s': round(t_call_steady, 2),
              'simlike_s': round(t_simlike, 2),
              'refr_count_s': round(t_refrcount, 2),
              'align_engine': align_engine,
              'call_contigs_per_s': round(n_contigs / t_call_steady, 1),
              'trio_to_vcf_total_s': round(wall_to_vcf, 1),
              'denovo_pass': found, 'denovo_called': called,
              'denovo_total': len(truth),
              'pass_calls': len(calls)}})

    # ------------------------- config 5: hash-sharded sketches over the mesh
    shards = n_devices
    t_count5 = timed_stage(
        ['count', '-k', 31, '-M', args.memory, '--max-fpr', 0.6,
         '--shards', shards, 'proband-sharded.ct', 'proband.fq'])
    t_novel5 = timed_stage(
        ['novel', '-k', 31, '--case', 'proband.fq', '--shards', shards,
         '--case-counts', 'proband-sharded.ct',
         '--control-counts', 'mother.ct', 'father.ct',
         '--ctrl-max', 1, '--case-min', args.case_min,
         '--out', 'novel-sharded.augfastq'])
    same = (open('novel-sharded.augfastq').read() ==
            open('novel.augfastq').read())
    emit({'config': 5, 'metric': 'sharded_count_novel_wall_s',
          'value': round(t_count5 + t_novel5, 2), 'unit': 's',
          'backend': backend, 'detail': {
              'shards': shards, 'devices': n_devices,
              'count_s': round(t_count5, 2), 'novel_s': round(t_novel5, 2),
              'output_identical_to_unsharded': same,
              'note': ('single-chip hardware: mesh of {} shard(s); '
                       'multi-shard equivalence is pinned on the 8-device '
                       'CPU mesh (tests/test_cli_sharded.py) and in '
                       'dryrun_multichip'.format(shards))}})

    artifact = {'suite': 'BASELINE benchmark configs 2-5',
                'backend': backend, 'devices': n_devices,
                'genome_size': args.genome_size, 'coverage': args.coverage,
                'error_rate': args.error, 'results': results}
    outpath = os.path.join(REPO, 'BENCH_CONFIGS.json')
    with open(outpath, 'w') as fh:
        json.dump(artifact, fh, indent=2)
        fh.write('\n')
    print('# wrote', outpath, file=sys.stderr)
    if not args.keep and args.workdir is None:
        import shutil
        os.chdir(REPO)
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == '__main__':
    main()
