"""End-to-end verification drive (the .claude/skills/verify recipe).

Simulates a 20 kb genome + trio (3 inherited + 3 de novo SNVs), tiles
~14x/haplotype reads, runs count -> novel -> filter -> partition -> alac ->
simlike through the real CLI entry points, and checks the success
criterion: PASS calls == exactly the de novo truth rows (position, REF,
ALT), case ALTABUND ~ coverage, controls 0, LIKESCORE > 0.

Usage: KEVLAR_PLATFORM=cpu python tools/verify_e2e.py   (host backend,
~1-2 min) or without the env var on the accelerator.
Prints VERIFY_PASS or VERIFY_FAIL and exits nonzero on failure.
"""

import os
import random
import subprocess
import sys
import tempfile

PY = [sys.executable, '-m', 'kevlar_tpu']


def run(args, **kw):
    proc = subprocess.run(PY + args, stderr=subprocess.PIPE, **kw)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr.decode())
        raise SystemExit('stage failed: ' + ' '.join(args))


def tile_reads(fasta, fastq, readlen=100, step=7):
    seqs = {}
    name = None
    for line in open(fasta):
        line = line.strip()
        if line.startswith('>'):
            name = line[1:]
            seqs[name] = []
        else:
            seqs[name].append(line)
    with open(fastq, 'w') as out:
        n = 0
        for name, chunks in seqs.items():
            seq = ''.join(chunks)
            for start in range(0, len(seq) - readlen + 1, step):
                read = seq[start:start + readlen]
                out.write('@r{}\n{}\n+\n{}\n'.format(n, read, 'I' * readlen))
                n += 1


def vcf_rows(path, passonly=False):
    rows = []
    for line in open(path):
        if line.startswith('#'):
            continue
        fields = line.rstrip('\n').split('\t')
        if passonly and fields[6] != 'PASS':
            continue
        rows.append((fields[0], int(fields[1]), fields[3], fields[4],
                     fields[7]))
    return rows


def main():
    workdir = tempfile.mkdtemp(prefix='kevlar-verify-')
    os.chdir(workdir)
    print('verify workdir:', workdir)

    rng = random.Random(4242)
    with open('genome.fa', 'w') as fh:
        fh.write('>chr1\n' +
                 ''.join(rng.choice('ACGT') for _ in range(20000)) + '\n')
    run(['gentrio', '--vcf', 'truth.vcf', '--prefix', 'trio', '-i', '3',
         '-d', '3', '--weights', 'snv=1.0', '--seed', '11', 'genome.fa'])
    for person in ('proband', 'mother', 'father'):
        tile_reads('trio-{}.fasta'.format(person), person + '.fq')
        run(['count', '-k', '31', '-M', '8M', person + '.ct', person + '.fq'])
    run(['novel', '-k', '31', '--case', 'proband.fq', '--case-counts',
         'proband.ct', '--control-counts', 'mother.ct', 'father.ct',
         '--ctrl-max', '1', '--case-min', '6', '-o', 'novel.augfastq'])
    run(['filter', 'novel.augfastq', '-o', 'filtered.augfastq'])
    run(['partition', 'filtered.augfastq', '-o', 'partitioned.augfastq'])
    run(['alac', '-k', '31', 'partitioned.augfastq', 'genome.fa', '-o',
         'calls.vcf'])
    run(['count', '-k', '31', '-c', '4', '-M', '4M', 'refr.sct', 'genome.fa'])
    run(['simlike', '--case', 'proband.ct', '--controls', 'mother.ct',
         'father.ct', '--refr', 'refr.sct', '--mu', '28', '--sigma', '8',
         '-o', 'scored.vcf', 'calls.vcf'])

    truth_denovo = {(c, p, r, a) for c, p, r, a, info in vcf_rows('truth.vcf')
                    if 'GT=0/1,0/0,0/0' in info or 'GT=1/0,0/0,0/0' in info}
    passing = vcf_rows('scored.vcf', passonly=True)
    passset = {(c, p, r, a) for c, p, r, a, _ in passing}
    ok = passset == truth_denovo
    for _, _, _, _, info in passing:
        like = [kv for kv in info.split(';') if kv.startswith('LIKESCORE=')]
        if not like or float(like[0].split('=')[1]) <= 0:
            ok = False
    print('truth de novo:', sorted(truth_denovo))
    print('PASS calls:   ', sorted(passset))
    print('VERIFY_PASS' if ok else 'VERIFY_FAIL')
    raise SystemExit(0 if ok else 1)


if __name__ == '__main__':
    main()
