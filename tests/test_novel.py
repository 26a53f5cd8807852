"""novel-k-mer screen: trio simulation, threshold semantics, banding."""

import random

import pytest

import kevlar_tpu
from kevlar_tpu import dna
from kevlar_tpu.novel import novel
from kevlar_tpu.sketch import Sketch
from kevlar_tpu.count import consume_seqfile

from . import simdata

KSIZE = 21


@pytest.fixture(scope='module')
def trio():
    rng = random.Random(1234)
    genome = simdata.make_genome(rng, 2000)
    snvpos = 987
    child_genome, ref, alt = simdata.apply_snv(genome, snvpos, rng=rng)
    child_reads = simdata.tiled_reads(child_genome, readlen=100, step=10,
                                      prefix='child')
    mom_reads = simdata.tiled_reads(genome, readlen=100, step=10,
                                    prefix='mom')
    dad_reads = simdata.tiled_reads(genome, readlen=100, step=10,
                                    prefix='dad')
    return dict(genome=genome, child_genome=child_genome, snvpos=snvpos,
                ref=ref, alt=alt, child=child_reads, mom=mom_reads,
                dad=dad_reads)


def _count_reads(reads, ksize=KSIZE, tablesize=100003):
    import numpy as np
    from kevlar_tpu.batch import batches_from_records
    ct = Sketch(ksize, tablesize, 4, counter_bits=8)
    for b in batches_from_records(iter(reads)):
        ct.consume_batch(b.bases)
    return ct


@pytest.fixture(scope='module')
def trio_sketches(trio):
    case = _count_reads(trio['child'])
    mom = _count_reads(trio['mom'])
    dad = _count_reads(trio['dad'])
    return case, mom, dad


def test_novel_finds_snv_kmers(trio, trio_sketches):
    case, mom, dad = trio_sketches
    results = list(novel(iter(trio['child']), [case], [mom, dad],
                         ksize=KSIZE, casemin=6, ctrlmax=0))
    assert len(results) > 0
    # every annotated k-mer must span the SNV in the child genome
    child_genome = trio['child_genome']
    snvpos = trio['snvpos']
    spanning = {child_genome[p:p + KSIZE]
                for p in range(snvpos - KSIZE + 1, snvpos + 1)
                if p >= 0 and p + KSIZE <= len(child_genome)}
    spanning |= {dna.revcom(s) for s in spanning}
    for record in results:
        assert len(record.annotations) > 0
        for ik in record.annotations:
            kmerseq = record.ikmerseq(ik)
            assert kmerseq in spanning
            # abundance thresholds hold: case >= 6, controls <= 0
            assert ik.abund[0] >= 6
            assert all(a == 0 for a in ik.abund[1:])


def test_novel_no_variants_no_output(trio, trio_sketches):
    _, mom, dad = trio_sketches
    momct = mom
    results = list(novel(iter(trio['mom'][:50]), [momct], [momct],
                         ksize=KSIZE, casemin=6, ctrlmax=0))
    # case == control -> all interesting kmers also abundant in control
    assert results == []


def test_novel_skips_reads_with_n(trio_sketches):
    case, mom, dad = trio_sketches
    from kevlar_tpu.sequence import Record
    rec = Record(name='weird', sequence='ACGTN' * 20, quality='I' * 100)
    results = list(novel(iter([rec]), [case], [mom, dad], ksize=KSIZE,
                         casemin=1, ctrlmax=255))
    assert results == []


@pytest.mark.parametrize('numbands', [2, 4, 8])
def test_novel_band_union_equals_full(trio, trio_sketches, numbands):
    """Band-union == full-screen parity across band counts: pins the
    deliberate deviation from the reference's novel-loop double-decrement
    quirk (reference novel.py:144-147,184; PARITY.md known deviations) so
    unband-merge parity cannot silently drift at any band count."""
    case, mom, dad = trio_sketches
    full = list(novel(iter(trio['child']), [case], [mom, dad],
                      ksize=KSIZE, casemin=6, ctrlmax=0))
    banded = []
    for band in range(numbands):
        banded.extend(novel(iter(trio['child']), [case], [mom, dad],
                            ksize=KSIZE, casemin=6, ctrlmax=0,
                            numbands=numbands, band=band))
    full_ann = {(r.name, ik.offset) for r in full for ik in r.annotations}
    band_ann = {(r.name, ik.offset) for r in banded for ik in r.annotations}
    assert full_ann == band_ann


def test_abund_screen_discards_read(trio, trio_sketches):
    case, mom, dad = trio_sketches
    from kevlar_tpu.sequence import Record
    # a read with novel content absent from the case sketch (abund 0 < screen)
    alien = Record(name='alien', sequence='TGCA' * 25, quality='I' * 100)
    results = list(novel(iter([alien]), [case], [mom, dad], ksize=KSIZE,
                         casemin=6, ctrlmax=0, abundscreen=2))
    assert results == []


def test_band_args_must_pair(trio_sketches):
    case, mom, dad = trio_sketches
    with pytest.raises(ValueError):
        list(novel(iter([]), [case], [mom], numbands=4))
    with pytest.raises(ValueError):
        list(novel(iter([]), [case], [mom], numbands=4, band=-1))


def test_fused_count_and_screen_matches_unfused():
    """count_and_screen_stack_packed (one dispatch, 2-bit wire, packed-word
    tables) must reproduce the unfused consume+screen path bit-exactly."""
    import numpy as np
    import jax.numpy as jnp
    from kevlar_tpu.batch import pack_bases
    from kevlar_tpu.ops import novel_ops

    rng = np.random.default_rng(99)
    L, B, NB, TS = 64, 16, 2, 4099

    def mkstack():
        return rng.integers(0, 4, size=(NB, B, L), dtype=np.uint8)

    case, mom, dad = mkstack(), mkstack(), mkstack()
    case[0, 0, 7] = 4  # an N: read must be skipped wholesale
    lens = np.full((NB, B), L, np.int32)

    sks = [Sketch(KSIZE, TS, 4, counter_bits=8) for _ in range(3)]
    for sk, st in zip(sks, (case, mom, dad)):
        sk.consume_batch_stack(st)
    from kevlar_tpu.ops.novel_ops import novel_screen_compact_stack
    ref = novel_screen_compact_stack(
        (sks[0].tables,), tuple(s.tables for s in sks[1:]),
        jnp.asarray(case), jnp.asarray(lens), ksize=KSIZE, casemin=2,
        ctrlmax=1)

    packed = [pack_bases(st) for st in (case, mom, dad)]
    outs, case_tables, ctrl_tables = novel_ops.count_and_screen_stack_packed(
        jnp.asarray(packed[0][0]), jnp.asarray(packed[0][1]),
        tuple(jnp.asarray(p) for p, _ in packed[1:]),
        tuple(jnp.asarray(b) for _, b in packed[1:]),
        jnp.asarray(lens), L=L, ksize=KSIZE, tablesize=TS, ntables=4,
        maxcount=255, casemin=2, ctrlmax=1)
    for name, (x, y) in zip(('hit_idx', 'hit_abunds', 'n_hits', 'discard',
                             'skip'), zip(ref, outs)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name
    assert np.array_equal(np.asarray(sks[0].tables), np.asarray(case_tables))


def test_fused_count_and_screen_matches_host_backend():
    """count_and_screen_stack_packed's tables equal Sketch(backend='host')
    counts of the same reads, and its hits are exactly the case k-mers
    that pass casemin/ctrlmax on those host counts."""
    import numpy as np
    import jax.numpy as jnp
    from kevlar_tpu import dna
    from kevlar_tpu.batch import pack_bases
    from kevlar_tpu.ops import novel_ops

    rng = np.random.default_rng(5)
    L, B, NB, TS, casemin, ctrlmax = 48, 16, 2, 2003, 3, 1
    genome = rng.integers(0, 4, size=400, dtype=np.uint8)

    def mkstack():
        starts = rng.integers(0, len(genome) - L, size=(NB, B))
        return genome[starts[..., None] + np.arange(L)]

    stacks = [mkstack(), mkstack(), mkstack()]
    stacks[0][1, 3, 10:13] = (stacks[0][1, 3, 10:13] + 1) % 4  # case-only
    lens = np.full((NB, B), L, np.int32)
    hosts = []
    for st in stacks:
        sk = Sketch(KSIZE, TS, 4, counter_bits=8, backend='host')
        sk.consume_batch_stack(st)
        hosts.append(sk)
    packed = [pack_bases(st) for st in stacks]
    outs, case_tables, ctrl_tables = novel_ops.count_and_screen_stack_packed(
        jnp.asarray(packed[0][0]), jnp.asarray(packed[0][1]),
        tuple(jnp.asarray(p) for p, _ in packed[1:]),
        tuple(jnp.asarray(b) for _, b in packed[1:]),
        jnp.asarray(lens), L=L, ksize=KSIZE, tablesize=TS, ntables=4,
        maxcount=255, casemin=casemin, ctrlmax=ctrlmax)
    for got, host in zip((case_tables,) + tuple(ctrl_tables), hosts):
        np.testing.assert_array_equal(np.asarray(got), host.tables)

    h1, h2, valid = dna.kmer_hashes(stacks[0].reshape(NB * B, L), KSIZE)
    counts = [h._host_counts(h1, h2) for h in hosts]
    want = (valid & (counts[0] >= casemin) & (counts[1] <= ctrlmax)
            & (counts[2] <= ctrlmax)).reshape(NB, -1)
    hit_idx, hit_abunds, n_hits, _, _ = (np.asarray(x) for x in outs)
    assert want.any()
    for b in range(NB):
        idx = np.flatnonzero(want[b])
        assert n_hits[b] == len(idx)
        np.testing.assert_array_equal(hit_idx[b, :len(idx)], idx)
        np.testing.assert_array_equal(
            hit_abunds[b, :, :len(idx)],
            np.stack([c.reshape(NB, -1)[b, idx] for c in counts]))


def test_novel_small_batches_match_one_batch(trio, trio_sketches):
    """Stacked-dispatch batching (8-deep flush + partial tail + shape-change
    flushes) must produce exactly the same annotated records, in the same
    order, as one big batch."""
    case, mom, dad = trio_sketches
    big = list(novel(iter(trio['child']), [case], [mom, dad],
                     ksize=KSIZE, casemin=6, ctrlmax=0))
    small = list(novel(iter(trio['child']), [case], [mom, dad],
                       ksize=KSIZE, casemin=6, ctrlmax=0, batch_size=8))
    assert [(r.name, [(ik.offset, ik.abund) for ik in r.annotations])
            for r in big] == \
           [(r.name, [(ik.offset, ik.abund) for ik in r.annotations])
            for r in small]


def test_novel_packed_wire_matches_raw(trio, trio_sketches, monkeypatch):
    """The 2-bit wire format for the stacked screen (default) must yield
    byte-identical annotations to the raw uint8 wire."""
    case, mom, dad = trio_sketches

    def run():
        return [(r.name, [(ik.offset, ik.abund) for ik in r.annotations])
                for r in novel(iter(trio['child']), [case], [mom, dad],
                               ksize=KSIZE, casemin=6, ctrlmax=0,
                               batch_size=8)]

    monkeypatch.setenv('KEVLAR_PACKED_WIRE', '1')
    packed = run()
    monkeypatch.setenv('KEVLAR_PACKED_WIRE', '0')
    raw = run()
    assert packed == raw
    assert any(anns for _name, anns in packed)


def test_masked_count_packed_wire_matches_raw(trio, tmp_path, monkeypatch):
    """Masked counting (the workflow's per-sample stage) over the 2-bit
    wire must produce tables identical to the raw uint8 wire."""
    import numpy as np
    from kevlar_tpu.count import consume_seqfile

    mask = Sketch(KSIZE, 100003, 4, counter_bits=1)
    mask.consume(trio['genome'])
    fq = str(tmp_path / 'reads.fq')
    with open(fq, 'w') as fh:
        for r in trio['child']:
            fh.write('@{}\n{}\n+\n{}\n'.format(
                r.name, r.sequence, 'I' * len(r.sequence)))

    def count(env):
        monkeypatch.setenv('KEVLAR_PACKED_WIRE', env)
        ct = Sketch(KSIZE, 100003, 4, counter_bits=8)
        consume_seqfile(ct, [fq], mask=mask, batch_size=64)
        return np.asarray(ct.tables)

    assert (count('1') == count('0')).all()


def test_novel_text_emit_matches_record_emit(trio, trio_sketches):
    """emit='text' (the production write path: columnar arrays straight to
    augmented-FASTX text) must produce byte-identical output to formatting
    the emitted Records one by one."""
    import io
    case, mom, dad = trio_sketches

    recbuf = io.StringIO()
    for record in novel(iter(trio['child']), [case], [mom, dad],
                        ksize=KSIZE, casemin=6, ctrlmax=0):
        kevlar_tpu.print_augmented_fastx(record, recbuf)
    text = ''.join(novel(iter(trio['child']), [case], [mom, dad],
                         ksize=KSIZE, casemin=6, ctrlmax=0, emit='text'))
    assert recbuf.getvalue() == text
    assert text.count('#\n') > 0
