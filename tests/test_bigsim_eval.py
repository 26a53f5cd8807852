"""Pin the bigsim evaluation protocol (tools/bigsim_bench.py).

The bigsim accuracy figures are only as trustworthy as their scorer; these
tests pin the protocol mirrored from the reference's
notebook/bigsim/evaluate.py: calls ranked by LIKESCORE, tolerance-10
interval match against truth, first match wins (repeats are collisions),
per-type/size recall classes, non-PASS calls ignored.
"""

import importlib.util
import os
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bigsim():
    path = os.path.join(REPO, 'tools', 'bigsim_bench.py')
    spec = importlib.util.spec_from_file_location('bigsim_bench', path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault('bigsim_bench', mod)
    spec.loader.exec_module(mod)
    return mod


def _write_vcf(path, rows):
    with open(path, 'w') as fh:
        fh.write('##fileformat=VCFv4.2\n')
        fh.write('#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n')
        for row in rows:
            fh.write('\t'.join(str(x) for x in row) + '\n')


def test_truth_rows_denovo_only(tmp_path):
    bigsim = _load_bigsim()
    vcf = tmp_path / 'truth.vcf'
    _write_vcf(vcf, [
        # de novo SNV (child het, both parents hom-ref)
        ('chrS', 101, '.', 'A', 'C', '.', '.', 'GT=0/1,0/0,0/0'),
        # inherited -> excluded
        ('chrS', 201, '.', 'G', 'T', '.', '.', 'GT=0/1,0/1,0/0'),
        # de novo 30 bp insertion
        ('chrS', 301, '.', 'T', 'T' + 'A' * 30, '.', '.', 'GT=1/0,0/0,0/0'),
        # de novo 12 bp deletion
        ('chrS', 401, '.', 'C' + 'G' * 12, 'C', '.', '.', 'GT=0/1,0/0,0/0'),
    ])
    rows = bigsim.truth_rows(str(vcf))
    assert rows == [(100, 'SNV', 0), (300, 'INDEL', 30), (400, 'INDEL', 12)]


def test_evaluate_matching_collisions_and_classes(tmp_path):
    bigsim = _load_bigsim()
    truth = [(100, 'SNV', 0), (300, 'INDEL', 30), (5000, 'INDEL', 150)]
    vcf = tmp_path / 'scored.vcf'
    _write_vcf(vcf, [
        # exact SNV hit
        ('chrS', 101, '.', 'A', 'C', '.', 'PASS', 'LIKESCORE=200'),
        # second call on the same SNV -> collision, not a new TP
        ('chrS', 105, '.', 'G', 'T', '.', 'PASS', 'LIKESCORE=150'),
        # insertion called 8 bp off -> inside tolerance 10
        ('chrS', 309, '.', 'T', 'T' + 'A' * 30, '.', 'PASS', 'LIKESCORE=90'),
        # far from any truth row -> FP (SNV-shaped)
        ('chrS', 9000, '.', 'A', 'G', '.', 'PASS', 'LIKESCORE=50'),
        # non-PASS calls never count, even on a truth position
        ('chrS', 5001, '.', 'C', 'C' + 'G' * 150, '.', 'ControlAbundance',
         'LIKESCORE=999'),
    ])
    ev = bigsim.evaluate(truth, str(vcf))
    assert ev['tp'] == 2
    assert ev['fp'] == 1
    assert ev['collisions'] == 1
    assert ev['total_truth'] == 3
    assert ev['recall'] == round(2 / 3, 4)
    assert ev['fdr'] == round(1 / 3, 4)
    per = ev['per_class']
    assert per['SNVs'] == dict(total=1, tp=1, fp=0, recall=1.0)
    assert per['INDELs 11-100bp']['tp'] == 1
    # the filtered 150 bp indel was never matched
    assert per['INDELs 101-200bp'] == dict(total=1, tp=0, fp=0, recall=0.0)


def test_reference_protocol_compaction_and_points(tmp_path):
    bigsim = _load_bigsim()
    truth = [(100, 'SNV', 0), (300, 'INDEL', 30)]
    calls = [
        # class 7: first call misses, second matches -> keep the match
        (500, 90.0, '7', 1), (305, 80.0, '7', 31),
        # class 8: no call matches -> keep first in order; it's an FP
        (900, 70.0, '8', 1), (950, 60.0, '8', 1),
        # classless call matching the SNV point within delta
        (95, 50.0, None, 1),
        # LIKESCORE <= 0 compacted away
        (100, 0.0, None, 1),
    ]
    ev = bigsim.evaluate_reference_protocol(truth, calls)
    assert ev['calls_compacted'] == 3
    assert ev['tp'] == 2 and ev['fp'] == 1 and ev['missing'] == 0
    assert ev['calls_correct'] == 2
    assert ev['per_class']['INDELs 11-100bp']['tp'] == 1


def test_reference_truth_tsv_and_published_calls():
    """Score the reference's own checked-in 30x calls against its own truth
    set: the head-to-head anchor recorded in ACCURACY_BIGSIM.json. The
    per-class TP counts must bracket the reference's ROC maxima (the ROC
    applies further thresholding, so scorer TP >= ROC max is expected but
    only by a small margin)."""
    import pytest
    bigsim = _load_bigsim()
    anchor = bigsim.score_reference_calls()
    if anchor is None:
        pytest.skip('reference bigsim artifacts not mounted')
    assert anchor['total_truth'] == 1646
    op = bigsim.reference_operating_point()
    for cls, stats in anchor['per_class'].items():
        assert op[cls]['max_tp'] <= stats['tp'] <= op[cls]['max_tp'] + 8, cls
    assert 0.90 <= anchor['recall'] <= 0.93
    assert anchor['fdr'] < 0.05


def test_evaluate_tolerance_boundary(tmp_path):
    bigsim = _load_bigsim()
    truth = [(1000, 'SNV', 0)]
    hit = tmp_path / 'hit.vcf'
    # call interval [1010, 1011): 1010 - 10 < 1001 and 1000 - 10 < 1011
    _write_vcf(hit, [('chrS', 1011, '.', 'A', 'C', '.', 'PASS',
                      'LIKESCORE=10')])
    assert bigsim.evaluate(truth, str(hit))['tp'] == 1
    miss = tmp_path / 'miss.vcf'
    # call interval [1011, 1012): 1011 - 10 = 1001 is not < 1001 -> miss
    _write_vcf(miss, [('chrS', 1012, '.', 'A', 'C', '.', 'PASS',
                       'LIKESCORE=10')])
    ev = bigsim.evaluate(truth, str(miss))
    assert ev['tp'] == 0 and ev['fp'] == 1
