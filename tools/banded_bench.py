"""Banded large-genome mode at a scale that needs it (BASELINE config 5).

The reference's banding use-case (/root/reference/docs/banding.rst:4-6) is
counting memory: N passes at 1/N table memory each.  This driver runs a
trio with uncorrected-read-class sketch sizing (default: 300 Mb genome at
30x — the reference's tutorial recommends 36-72 GB/sample for human WGS,
i.e. ~4-7 GB/sample at 1/10 scale) through the complete banded
pipeline:

  per band:  count case/mother/father   (--num-bands N --band i)
             novel screen               (--num-bands N --band i)
  merge:     unband
  then:      filter -> partition -> alac -> simlike -> evaluate

simlike scores against the per-band tables directly (comma-separated
--case/--controls/--refr lists -> BandedSketchView; the reference's
simlike has no banded mode — its published runs loaded full tables into
host RAM).

Per-band resident table bytes, peak RSS, and (when the backend exposes
it) device memory are recorded to show the 1/N memory contract.

Usage: python tools/banded_bench.py [--genome-size 300000000]
       [--num-bands 4] [--sample-mem 4G] [--out BENCH_BANDED.json]
       (smoke: --genome-size 5000000 --sample-mem 64M)
"""

import argparse
import json
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault('KEVLAR_BATCH_READS', '16384')

from bigsim_bench import (simulate_genome, simulate_repeat_genome,
                          timed_stage, truth_rows, evaluate,
                          evaluate_reference_protocol, read_pass_calls)


def peak_rss_mb():
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                 1)


def device_mem_mb():
    try:
        import jax
        stats = jax.devices()[0].memory_stats()
        if stats and 'bytes_in_use' in stats:
            return round(stats['bytes_in_use'] / 1e6, 1)
    except Exception:
        pass
    return None


def parse_mem(s):
    mult = {'K': 1e3, 'M': 1e6, 'G': 1e9}
    if s[-1].upper() in mult:
        return int(float(s[:-1]) * mult[s[-1].upper()])
    return int(float(s))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--genome-size', type=int, default=300_000_000)
    ap.add_argument('--coverage', type=int, default=30)
    ap.add_argument('--error', type=float, default=0.002)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--denovo', type=int, default=500)
    ap.add_argument('--inherited', type=int, default=300)
    ap.add_argument('--num-bands', type=int, default=4)
    ap.add_argument('--sample-mem', default=None,
                    help='UNBANDED per-sample sketch budget; each band '
                         'allocates 1/N of it (default: uncorrected-read '
                         'sizing ~14 bytes/genome-bp)')
    ap.add_argument('--seed', type=int, default=20260821)
    ap.add_argument('--repeats', action='store_true')
    ap.add_argument('--workdir', default=None)
    ap.add_argument('--skip-sim', action='store_true',
                    help='workdir already holds genome.fa/truth.vcf/*.fq')
    ap.add_argument('--out', default=os.path.join(REPO,
                                                  'BENCH_BANDED.json'))
    args = ap.parse_args()

    N = args.num_bands
    if N & (N - 1):
        raise SystemExit('--num-bands must be a power of two')
    # uncorrected-read sizing: distinct k-mers ~= genome + ~2*G*cov*err*k/2
    # error k-mers; 6 bytes/distinct keeps per-table occupancy < ~60%
    # (tutorial.rst's 36-72 GB/sample for human WGS is this same rule)
    distinct = args.genome_size + int(
        2 * args.genome_size * args.coverage * args.error * 31 / 2)
    total_mem = parse_mem(args.sample_mem) if args.sample_mem else \
        int(distinct * 6)
    band_mem = str(int(total_mem // N))

    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_banded_')
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    print('# workdir:', workdir, file=sys.stderr)
    print('# per-sample unbanded budget {:.2f} GB; per-band {:.2f} GB; '
          'trio+refr unbanded would be {:.1f} GB'.format(
              total_mem / 1e9, total_mem / N / 1e9,
              (3 * total_mem + args.genome_size * 3) / 1e9),
          file=sys.stderr)

    wall = {}
    mem = {'band_table_bytes_per_sample': int(total_mem // N),
           'unbanded_table_bytes_per_sample': int(total_mem)}
    t0 = time.time()
    if not args.skip_sim:
        from sim_trio_bench import simulate_reads
        import random
        if args.repeats:
            simulate_repeat_genome('genome.fa', args.genome_size, args.seed)
        else:
            simulate_genome('genome.fa', args.genome_size, args.seed)
        timed_stage(['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
                     '--inherited', args.inherited, '--de-novo',
                     args.denovo, '--seed', args.seed, 'genome.fa'])
        rng = random.Random(args.seed)
        for who in ('proband', 'mother', 'father'):
            n = simulate_reads('trio-{}.fasta'.format(who), who + '.fq',
                               args.coverage, args.readlen, args.error,
                               rng.randrange(1 << 30))
            print('#', who, n, 'reads', file=sys.stderr)
        wall['simulate'] = round(time.time() - t0, 1)
        print('# sim wall', wall['simulate'], file=sys.stderr)

    # banded counting: 3 samples x N bands, each pass at 1/N table memory
    for who, fpr in (('proband', 0.6), ('mother', 0.3), ('father', 0.3)):
        for band in range(1, N + 1):
            key = 'count_{}_b{}'.format(who, band)
            wall[key] = round(timed_stage(
                ['count', '-k', 31, '-M', band_mem, '--max-fpr', fpr,
                 '--num-bands', N, '--band', band,
                 '{}.b{}.ct'.format(who, band), who + '.fq']), 1)
            mem.setdefault('rss_after_count_mb', {})[key] = peak_rss_mb()
            dm = device_mem_mb()
            if dm is not None:
                mem.setdefault('device_mb_after', {})[key] = dm
            print('#', key, wall[key], 's rss', peak_rss_mb(), 'MB',
                  file=sys.stderr)

    # banded novel screen + unband merge
    for band in range(1, N + 1):
        key = 'novel_b{}'.format(band)
        wall[key] = round(timed_stage(
            ['novel', '-k', 31, '--num-bands', N, '--band', band,
             '--case', 'proband.fq',
             '--case-counts', 'proband.b{}.ct'.format(band),
             '--control-counts', 'mother.b{}.ct'.format(band),
             'father.b{}.ct'.format(band),
             '--ctrl-max', 1, '--case-min', 5,
             '--out', 'novel.b{}.augfastq'.format(band)]), 1)
        print('#', key, wall[key], 's', file=sys.stderr)
    import kevlar_tpu
    import kevlar_tpu.cli as cli
    t = time.time()
    uargs = cli.parse_args(
        ['unband', '--out', 'novel.augfastq'] +
        ['novel.b{}.augfastq'.format(b) for b in range(1, N + 1)])
    kevlar_tpu.unband.main(uargs)
    wall['unband'] = round(time.time() - t, 1)

    wall['filter'] = round(timed_stage(
        ['filter', '-M', '1G', '--max-fpr', 0.05, '--case-min', 5,
         '--out', 'filtered.augfastq', 'novel.augfastq']), 1)
    wall['partition'] = round(timed_stage(
        ['partition', '--out', 'partitioned.augfastq',
         'filtered.augfastq']), 1)
    wall['alac'] = round(timed_stage(
        ['alac', '-k', 31, '--out', 'calls.vcf', '--delta', 50,
         '--seed-size', 51, 'partitioned.augfastq', 'genome.fa']), 1)
    refr_mem = str(int(args.genome_size * 3))
    wall['refr_count'] = round(timed_stage(
        ['count', '-k', 31, '-c', 4, '-M', refr_mem, '--max-fpr', 0.5,
         'refr.sct', 'genome.fa']), 1)
    bandlist = lambda who: ','.join(
        '{}.b{}.ct'.format(who, b) for b in range(1, N + 1))
    wall['simlike'] = round(timed_stage(
        ['simlike', '--case', bandlist('proband'),
         '--controls', bandlist('mother'), bandlist('father'),
         '--refr', 'refr.sct', '--case-min', 5, '--mu', args.coverage,
         '--sigma', args.coverage * 0.3,
         '--out', 'scored.vcf', 'calls.vcf']), 1)
    for k in ('unband', 'filter', 'partition', 'alac', 'refr_count',
              'simlike'):
        print('#', k, wall[k], 's', file=sys.stderr)

    truth = truth_rows('truth.vcf')
    ev = evaluate(truth, 'scored.vcf')
    ev_ref = evaluate_reference_protocol(truth,
                                         read_pass_calls('scored.vcf'))
    import jax
    result = {
        'suite': 'banded large-genome mode (BASELINE config 5)',
        'backend': jax.default_backend(),
        'genome_size': args.genome_size, 'coverage': args.coverage,
        'num_bands': N, 'per_band_memory': band_mem,
        'unbanded_memory_per_sample': int(total_mem),
        'memory': dict(mem, peak_rss_mb=peak_rss_mb()),
        'repeat_genome': bool(args.repeats),
        'wall_s': wall, 'total_wall_s': round(sum(wall.values()), 1),
        'evaluation': ev,
        'evaluation_reference_protocol': ev_ref,
        'note': ('each counting pass holds one 1/N-size band table '
                 'resident; simlike scores through BandedSketchView over '
                 'the N band files (reference analog: docs/banding.rst, '
                 'which covers count+novel only)'),
    }
    with open(args.out, 'w') as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({'metric': 'banded_recall', 'value': ev['recall'],
                      'unit': 'fraction', 'fdr': ev['fdr'],
                      'num_bands': N,
                      'total_wall_s': result['total_wall_s']}))
    print('# wrote', args.out, file=sys.stderr)


if __name__ == '__main__':
    main()
