"""CLI surface: help/parse smoke tests for every subcommand + a CLI-driven
pipeline run (stages driven through the parser, as the reference tests do)."""

import random

import pytest

import kevlar_tpu
import kevlar_tpu.cli
from kevlar_tpu.cli import parser, parse_args, mains, memory_setting

from . import simdata

# the reference's 16 subcommands plus kevlar-tpu's own `warm`
SUBCOMMANDS = ['count', 'novel', 'filter', 'augment', 'assemble', 'mutate',
               'gentrio', 'partition', 'localize', 'call', 'alac',
               'varfilter', 'simlike', 'split', 'dist', 'unband', 'warm']


@pytest.mark.parametrize('subcommand', SUBCOMMANDS)
def test_help_messages(subcommand, capsys):
    with pytest.raises(SystemExit):
        parser().parse_args([subcommand, '-h'])
    out, err = capsys.readouterr()
    assert subcommand in out or 'usage' in out


def test_version(capsys):
    with pytest.raises(SystemExit):
        parser().parse_args(['-v'])
    out, err = capsys.readouterr()
    assert 'kevlar-tpu' in out or 'kevlar-tpu' in err


def test_memory_setting():
    assert memory_setting('1e6') == 1e6
    assert memory_setting('500M') == 5e8
    assert memory_setting('8G') == 8e9
    assert memory_setting('16K') == 16e3


def test_mains_registry():
    m = mains()
    assert sorted(m.keys()) == sorted(SUBCOMMANDS)


def test_cli_count_novel_roundtrip(tmp_path):
    """Drive count + novel through the CLI and check the augfastx output."""
    rng = random.Random(99)
    genome = simdata.make_genome(rng, 1500)
    child_genome, ref, alt = simdata.apply_snv(genome, 700, rng=rng)
    child = simdata.tiled_reads(child_genome, 100, 10, 'child')
    parent = simdata.tiled_reads(genome, 100, 10, 'parent')
    childfq = str(tmp_path / 'child.fq')
    parentfq = str(tmp_path / 'parent.fq')
    simdata.write_fastq(child, childfq)
    simdata.write_fastq(parent, parentfq)

    childct = str(tmp_path / 'child.ct')
    parentct = str(tmp_path / 'parent.ct')
    for fq, ct in [(childfq, childct), (parentfq, parentct)]:
        args = parse_args(['count', '-k', '21', '-M', '4M', ct, fq])
        mains()['count'](args)

    outfile = str(tmp_path / 'novel.augfastq')
    args = parse_args([
        'novel', '-k', '21', '--case', childfq, '--case-counts', childct,
        '--control-counts', parentct, '--ctrl-max', '0', '--case-min', '6',
        '-o', outfile])
    mains()['novel'](args)

    records = list(kevlar_tpu.parse_augmented_fastx(
        kevlar_tpu.open(outfile, 'r')))
    assert len(records) > 0
    for record in records:
        assert len(record.annotations) > 0
        for ik in record.annotations:
            assert ik.abund[0] >= 6
            assert ik.abund[1] == 0


def test_stage_logs_jax_platform_first(tmp_path, capsys):
    """Every stage's first log line names the JAX platform and device, so
    a run that landed on an unintended backend shows in its log."""
    rng = random.Random(3)
    fq = str(tmp_path / 'reads.fq')
    simdata.write_fastq(simdata.tiled_reads(simdata.make_genome(rng, 300),
                                            80, 20, 'r'), fq)
    kevlar_tpu.cli.main(['count', '-k', '21', '-M', '100K',
                         str(tmp_path / 'reads.ct'), fq])
    first = capsys.readouterr().err.splitlines()[0]
    assert first.startswith('[kevlar::count] JAX '), first
    assert ' on cpu: cpu x8' in first, first


def test_cli_gentrio_and_mutate(tmp_path):
    rng = random.Random(7)
    genome = simdata.make_genome(rng, 3000)
    genomefile = str(tmp_path / 'genome.fa')
    simdata.write_fasta({'chr1': genome}, genomefile)

    prefix = str(tmp_path / 'trio')
    vcffile = str(tmp_path / 'truth.vcf')
    args = parse_args(['gentrio', '--vcf', vcffile, '--prefix', prefix,
                       '-i', '4', '-d', '2', '--seed', '42', genomefile])
    mains()['gentrio'](args)
    import os
    for sample in ('proband', 'mother', 'father'):
        path = '{}-{}.fasta'.format(prefix, sample)
        assert os.path.exists(path)
        seqs = kevlar_tpu.seqio.parse_seq_dict(kevlar_tpu.open(path, 'r'))
        assert 'chr1_haplo1' in seqs and 'chr1_haplo2' in seqs
    truth = [ln for ln in open(vcffile) if not ln.startswith('#')]
    assert len(truth) == 6

    # mutate: apply an explicit SNV
    mutfile = str(tmp_path / 'muts.txt')
    with open(mutfile, 'w') as fh:
        fh.write('chr1\t100\tsnv\t1\n')
    outfile = str(tmp_path / 'mutated.fa')
    args = parse_args(['mutate', '-o', outfile, mutfile, genomefile])
    mains()['mutate'](args)
    seqs = kevlar_tpu.seqio.parse_seq_dict(kevlar_tpu.open(outfile, 'r'))
    assert seqs['chr1'][99] == genome[99]
    assert seqs['chr1'][100] != genome[100]
    assert seqs['chr1'][101] == genome[101]
