"""Large simulated-trio workflow benchmark + accuracy check.

Simulates a genome, a trio with inherited and de novo variants, and
error-bearing reads at the requested coverage (all numpy-vectorized so
genome sizes up to the reference's 25 Mb quick-start scale are cheap),
then runs the full mark-I workflow driver and scores the PASS calls
against the truth VCF.  Prints one JSON summary line.

Presets:
  --preset helium   mirrors the reference's quick-start scenario
                    (docs/quick-start.rst: 25 Mb genome, the expected
                    output is "5 variant calls: a 300 bp insertion and
                    4 SNVs", "< 5 minutes ... < 200 Mb of RAM" on a
                    laptop): 25 Mb genome, 30x trio, de novo = exactly
                    4 SNVs + one 300 bp insertion.

Usage:
    python tools/sim_trio_bench.py [--preset helium]
        [--genome-size N] [--coverage N] [--error F]
        [--threads N] [--workdir DIR]
    (KEVLAR_PLATFORM=cpu for the host backend; without --preset the
    defaults simulate a 1 Mb genome at 25x.)

The simulation, workflow configuration and scoring are functions that
chip_smoke.py reuses for its main-path phase.
"""

import argparse
import json
import os
import random
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ACGT = np.frombuffer(b'ACGT', dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(b'ACGT'):
    _CODE[_b] = _i


def write_genome(path, size, seed, width=80):
    """Random uniform genome as wrapped FASTA; returns the sequence."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=size, dtype=np.uint8)
    letters = _ACGT[codes]
    pad = (-size) % width
    rows = np.concatenate([letters, np.zeros(pad, np.uint8)])
    rows = rows.reshape(-1, width)
    out = np.full((rows.shape[0], width + 1), ord('\n'), np.uint8)
    out[:, :width] = rows
    body = out.tobytes().replace(b'\x00', b'')
    with open(path, 'wb') as fh:
        fh.write(b'>chr1\n')
        fh.write(body)
    return letters.tobytes().decode('ascii')


def _fasta_haplotypes(path):
    seqs = []
    with open(path) as fh:
        chunks = []
        for line in fh:
            if line.startswith('>'):
                if chunks:
                    seqs.append(''.join(chunks))
                chunks = []
            else:
                chunks.append(line.strip())
        if chunks:
            seqs.append(''.join(chunks))
    return seqs


def simulate_reads(fasta, out_fq, coverage, readlen, error, seed):
    """Vectorized whole-sample read simulation.

    Uniform start positions per haplotype, per-base substitution errors
    at rate ``error`` (uniform over the three other bases), fixed-width
    FASTQ records assembled as one byte matrix per chunk.
    """
    rng = np.random.default_rng(seed)
    total = 0
    chunk = 250_000
    with open(out_fq, 'wb') as out:
        for seq in _fasta_haplotypes(fasta):
            arr = _CODE[np.frombuffer(seq.encode('ascii'), np.uint8)]
            nreads = len(seq) * coverage // (2 * readlen)
            for off in range(0, nreads, chunk):
                m = min(chunk, nreads - off)
                starts = rng.integers(0, len(seq) - readlen, size=m)
                reads = arr[starts[:, None] + np.arange(readlen)]
                errs = rng.random((m, readlen)) < error
                nerr = int(errs.sum())
                if nerr:
                    rot = rng.integers(1, 4, size=nerr).astype(np.uint8)
                    reads[errs] = (reads[errs] + rot) & 3
                # fixed-width record: '@r' + 9 digits + '\n' SEQ '\n+\n'
                # QUAL '\n'
                rl = readlen
                rec = np.empty((m, 15 + 2 * rl + 1), np.uint8)
                rec[:, 0] = ord('@')
                rec[:, 1] = ord('r')
                nums = np.arange(total + 1, total + m + 1, dtype=np.int64)
                for j in range(9):
                    rec[:, 2 + j] = (nums // 10 ** (8 - j)) % 10 + ord('0')
                rec[:, 11] = ord('\n')
                rec[:, 12:12 + rl] = _ACGT[reads]
                rec[:, 12 + rl] = ord('\n')
                rec[:, 13 + rl] = ord('+')
                rec[:, 14 + rl] = ord('\n')
                rec[:, 15 + rl:15 + 2 * rl] = ord('I')
                rec[:, 15 + 2 * rl] = ord('\n')
                out.write(rec.tobytes())
                total += m
    return total


def helium_trio(genome, ninh, seed, ksize=31):
    """The quick-start scenario's exact de novo composition: 4 SNVs and
    one 300 bp insertion (heterozygous in the proband, absent in both
    parents), on top of ``ninh`` random inherited variants."""
    from kevlar_tpu import gentrio as g
    from kevlar_tpu.vcf import Variant

    rng = random.Random(seed)
    seqs = {'chr1': genome}
    variants = list(g.simulate_variant_genotypes(
        seqs, ninh=ninh, ndenovo=0, rng=rng))
    glen = len(genome)
    spots = sorted(rng.sample(range(glen // 20, glen - glen // 20), 5))
    for idx, pos in enumerate(spots):
        if idx < 4:
            alleles = g.mutate_snv(genome, pos, rng.randint(1, 3), ksize)
        else:
            src = rng.randint(0, glen - 400)
            alleles = g.mutate_insertion(genome, pos, 300, src, rng, ksize)
        refr, alt, refrwin, altwin = alleles
        var = Variant('chr1', pos, refr, alt, ALTWINDOW=altwin,
                      REFRWINDOW=refrwin)
        var.annotate('GT', '{},0/0,0/0'.format(rng.choice(['0/1', '1/0'])))
        variants.append(var)
    return variants


def write_trio(genome, variants, prefix, truthvcf):
    """Haplotype FASTAs for proband/mother/father + the truth VCF."""
    import kevlar_tpu
    from kevlar_tpu import gentrio as g

    ordered = sorted(variants, key=lambda v: v.position, reverse=True)
    for person, who in enumerate(('proband', 'mother', 'father')):
        with open('{}-{}.fasta'.format(prefix, who), 'w') as fh:
            haplos = g._haplotype_pair(genome, 'chr1', ordered, person)
            for hapnum, hap in enumerate(haplos, 1):
                print('>chr1_haplo', hapnum, '\n', hap, sep='', file=fh)
    with kevlar_tpu.open(truthvcf, 'w') as fh:
        kevlar_tpu.vcf_header(fh, source='kevlar::gentrio', infoheader=True)
        for var in sorted(variants, key=lambda v: (v.seqid, v.position)):
            print(var.vcf, file=fh)


def denovo_truth(truthvcf):
    """(pos, refr, alt) of rows with de novo genotypes (child het,
    parents hom-ref)."""
    rows = []
    with open(truthvcf) as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.split('\t')
            if 'GT=' not in f[7]:
                continue
            gtfield = [x for x in f[7].split(';')
                       if x.startswith('GT=')][0][3:]
            gts = gtfield.replace('|', '/').split(',')
            child, parents = gts[0], gts[1:]
            if sorted(child.split('/')) != ['0', '1']:
                continue
            if any(p != '0/0' for p in parents):
                continue
            rows.append((int(f[1]) - 1, f[3], f[4]))
    return rows


HELIUM = dict(genome_size=25_000_000, coverage=30, inherited=20)
DEFAULTS = dict(genome_size=1_000_000, coverage=25, inherited=10)


def simulate(genome_size, coverage, inherited, denovo=11, error=0.005,
             readlen=150, seed=20260818, helium=False, log=None):
    """Write genome.fa, truth.vcf and {proband,mother,father}.fq into the
    working directory; returns the number of reads per sample."""
    log = log or (lambda msg: print(msg, file=sys.stderr))
    t0 = time.time()
    genome = write_genome('genome.fa', genome_size, seed)
    if helium:
        variants = helium_trio(genome, inherited, seed)
        write_trio(genome, variants, 'trio', 'truth.vcf')
    else:
        import kevlar_tpu.cli as cli
        import kevlar_tpu.gentrio as gentrio_mod
        gargs = cli.parse_args([
            'gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio',
            '--inherited', str(inherited), '--de-novo', str(denovo),
            '--seed', str(seed), 'genome.fa'])
        gentrio_mod.main(gargs)
    del genome
    log('# simulated trio in {:.1f}s'.format(time.time() - t0))
    t0 = time.time()
    nreads = {}
    for i, who in enumerate(('proband', 'mother', 'father')):
        nreads[who] = simulate_reads('trio-{}.fasta'.format(who), who + '.fq',
                                     coverage, readlen, error, seed + 7 * i)
        log('# {}: {} reads'.format(who, nreads[who]))
    log('# simulated reads in {:.1f}s'.format(time.time() - t0))
    return nreads


def workflow_config(genome_size, coverage, threads=4, sketchmem=None):
    """The run_mark1 configuration of the simulated trio."""
    sketchmem = sketchmem or ('500M' if genome_size > 4_000_000 else '100M')
    return {
        'ksize': 31,
        'outdir': 'out',
        'reference': {'fasta': 'genome.fa'},
        'case': {'fastx': ['proband.fq'], 'label': 'Proband',
                 'memory': sketchmem, 'max_fpr': 0.6},
        'controls': [
            {'fastx': ['mother.fq'], 'label': 'Mother',
             'memory': sketchmem, 'max_fpr': 0.2},
            {'fastx': ['father.fq'], 'label': 'Father',
             'memory': sketchmem, 'max_fpr': 0.2},
        ],
        'mask': {'memory': '50M', 'max_fpr': 0.01},
        'novel': {'case_min': 5, 'ctrl_max': 1},
        'localize': {'seed_size': 51, 'delta': 50},
        'simlike': {'mu': coverage, 'sigma': coverage * 0.3,
                    'epsilon': 0.001},
        'threads': threads,
    }


def score_calls(finalvcf, truthvcf='truth.vcf'):
    """Score the PASS calls of ``finalvcf`` against the de novo truth:
    returns (found, truth_total, pass_calls, false_positives)."""
    truth = denovo_truth(truthvcf)
    import kevlar_tpu
    calls = []
    with kevlar_tpu.open(finalvcf, 'r') as fh:
        for line in fh:
            if line.startswith('#'):
                continue
            f = line.split('\t')
            if f[6] != 'PASS':
                continue
            calls.append((int(f[1]) - 1, f[3], f[4]))

    def matches(cp, cr, ca, pos, ref, alt):
        return abs(cp - pos) <= 10 and \
            (len(cr) - len(ca)) == (len(ref) - len(alt))

    found = sum(any(matches(*call, *row) for call in calls) for row in truth)
    fps = sum(not any(matches(*call, *row) for row in truth)
              for call in calls)
    return found, len(truth), len(calls), fps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--preset', choices=('helium',), default=None)
    ap.add_argument('--genome-size', type=int, default=None)
    ap.add_argument('--coverage', type=int, default=None)
    ap.add_argument('--error', type=float, default=0.005)
    ap.add_argument('--readlen', type=int, default=150)
    ap.add_argument('--inherited', type=int, default=None)
    ap.add_argument('--denovo', type=int, default=11)
    ap.add_argument('--seed', type=int, default=20260818)
    ap.add_argument('--threads', type=int, default=4)
    ap.add_argument('--sketch-mem', default=None)
    ap.add_argument('--workdir', default=None)
    args = ap.parse_args()

    helium = args.preset == 'helium'
    defaults = HELIUM if helium else DEFAULTS
    for key, value in defaults.items():
        if getattr(args, key) is None:
            setattr(args, key, value)

    import tempfile
    workdir = args.workdir or tempfile.mkdtemp(prefix='kevlar_trio_')
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    print('# workdir:', workdir, file=sys.stderr)

    t_all = time.time()
    simulate(args.genome_size, args.coverage, args.inherited, args.denovo,
             args.error, args.readlen, args.seed, helium)
    config = workflow_config(args.genome_size, args.coverage, args.threads,
                             args.sketch_mem)
    # the reference's quick start runs `bwa index refr.fa.gz` in its
    # untimed setup block (docs/quick-start.rst) before invoking the timed
    # snakemake workflow; our analog is the persistent seed index
    from kevlar_tpu.reference import autoindex
    t_idx = time.time()
    autoindex('genome.fa', config['localize']['seed_size'])
    index_wall = time.time() - t_idx
    print('# seed index built in {:.1f}s (untimed setup, as the '
          'reference quick-start does bwa index)'.format(index_wall),
          file=sys.stderr)

    # the timed window starts with the process's first device contact:
    # backend start-up and every compile are part of the workflow wall
    from kevlar_tpu.workflow import run_mark1
    t0 = time.time()
    finalvcf = run_mark1(config)
    wall = time.time() - t0

    found, total, npass, fps = score_calls(finalvcf)
    stages = dict(getattr(run_mark1, 'last_stage_times', []) or [])
    print(json.dumps({
        'metric': 'trio_workflow',
        'preset': args.preset,
        'stage_wall_s': stages,
        'genome_size': args.genome_size,
        'coverage': args.coverage,
        'error_rate': args.error,
        'denovo_found': found,
        'denovo_total': total,
        'pass_calls': npass,
        'false_positives': fps,
        'workflow_wall_s': round(wall, 1),
        'seed_index_wall_s': round(index_wall, 1),
        'total_wall_s': round(time.time() - t_all, 1),
        'peak_rss_mb': round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
    }))


if __name__ == '__main__':
    main()
