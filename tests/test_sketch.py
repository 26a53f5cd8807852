"""Count-Min sketch engine: counting semantics, persistence, FPR."""

import numpy as np
import pytest

import kevlar_tpu
from kevlar_tpu import dna, sketch
from kevlar_tpu.sketch import Sketch, allocate, estimate_fpr


def test_basic_counting():
    ct = Sketch(ksize=5, tablesize=10007, ntables=4)
    ct.consume('AAAAA')
    assert ct.get('AAAAA') == 1
    assert ct.get('TTTTT') == 1  # canonical
    ct.consume('AAAAA')
    assert ct.get('AAAAA') == 2
    assert ct.get('CCCCC') == 0


def test_consume_sequence_counts_every_window():
    ct = Sketch(ksize=3, tablesize=10007)
    n = ct.consume('ACGTACGT')  # 6 windows
    assert n == 6
    # canonical: ACG == revcom CGT (windows 0,1,4,5); GTA == TAC (2,3)
    assert ct.get('ACG') == 4
    assert ct.get('CGT') == 4
    assert ct.get('GTA') == 2


def test_duplicate_kmers_in_one_read_counted():
    ct = Sketch(ksize=3, tablesize=10007)
    ct.consume('AAAAA')  # AAA x3
    assert ct.get('AAA') == 3


def test_invalid_bases_skipped():
    ct = Sketch(ksize=3, tablesize=10007)
    n = ct.consume('ACNGT')
    assert n == 0
    assert ct.get('ACG') == 0  # nothing was counted
    import pytest as _pytest
    with _pytest.raises(ValueError):
        ct.get('ACN')  # non-ACGT k-mers are not hashable


def test_counter_saturation():
    ct = Sketch(ksize=3, tablesize=101, counter_bits=4)
    for _ in range(20):
        ct.consume('AAA')
    assert ct.get('AAA') == 15
    nt = Sketch(ksize=3, tablesize=101, counter_bits=1)
    nt.consume('AAACCC')
    assert nt.get('AAA') == 1


def test_get_kmer_counts():
    ct = Sketch(ksize=3, tablesize=10007)
    ct.consume('ACGTA')
    counts = ct.get_kmer_counts('ACGTA')
    assert counts == [ct.get('ACG'), ct.get('CGT'), ct.get('GTA')]


def test_batch_consume_matches_serial():
    import random
    rng = random.Random(11)
    seqs = [''.join(rng.choice('ACGT') for _ in range(50)) for _ in range(20)]
    ct1 = Sketch(ksize=21, tablesize=100003)
    bases, _ = dna.encode_batch(seqs)
    ct1.consume_batch(bases)
    ct2 = Sketch(ksize=21, tablesize=100003)
    for s in seqs:
        ct2.consume(s)
    np.testing.assert_array_equal(np.asarray(ct1.tables),
                                  np.asarray(ct2.tables))


def test_banding_partition_of_counts():
    """Union of banded sketches == unbanded sketch (banding contract)."""
    import random
    rng = random.Random(3)
    seqs = [''.join(rng.choice('ACGT') for _ in range(60)) for _ in range(10)]
    bases, _ = dna.encode_batch(seqs)
    full = Sketch(ksize=21, tablesize=100003)
    full.consume_batch(bases)
    numbands = 4
    merged = np.zeros((4, 100003), dtype=np.int32)
    total = 0
    for band in range(numbands):
        b = Sketch(ksize=21, tablesize=100003)
        total += b.consume_batch(bases, numbands=numbands, band=band)
        merged += np.asarray(b.tables).astype(np.int32)
    np.testing.assert_array_equal(np.minimum(merged, 255).astype(np.uint8),
                                  np.asarray(full.tables))
    assert total == int((np.asarray(full.tables)[0] > 0).sum()) or total > 0


def test_masked_consume():
    # note: mask k-mers are canonical, so CCCCC would also mask GGGGG;
    # use k-mers with distinct canonical forms
    mask = Sketch(ksize=5, tablesize=10007, counter_bits=1)
    mask.consume('AAAAA')
    ct = Sketch(ksize=5, tablesize=10007)
    bases, _ = dna.encode_batch(['AAAAA', 'ACGTC'])
    ct.consume_batch(bases, mask=mask, mask_threshold=0, consume_masked=False)
    assert ct.get('AAAAA') == 0  # in mask -> skipped
    assert ct.get('ACGTC') == 1
    ct2 = Sketch(ksize=5, tablesize=10007)
    ct2.consume_batch(bases, mask=mask, mask_threshold=1, consume_masked=True)
    assert ct2.get('AAAAA') == 1  # only-masked mode
    assert ct2.get('ACGTC') == 0


def test_save_load_roundtrip(tmp_path):
    ct = Sketch(ksize=5, tablesize=997, counter_bits=8)
    ct.consume('ACGTACGTAC')
    path = str(tmp_path / 'sample.ct')
    ct.save(path)
    loaded = sketch.load(path)
    assert loaded.ksize() == 5
    assert loaded.counter_bits == 8
    np.testing.assert_array_equal(np.asarray(loaded.tables),
                                  np.asarray(ct.tables))
    assert loaded.get('ACGTA') == ct.get('ACGTA')


def test_load_rejects_unknown_extension(tmp_path):
    with pytest.raises(sketch.KevlarSketchTypeError):
        sketch.load(str(tmp_path / 'foo.bogus'))


def test_estimate_fpr_and_occupancy():
    ct = Sketch(ksize=5, tablesize=1000)
    assert estimate_fpr(ct) == 0.0
    ct.consume('ACGTACGTACGTACGTACGT')
    occ = ct.n_occupied()
    assert occ > 0
    fpr = estimate_fpr(ct)
    assert 0 < fpr < 1
    assert abs(fpr - (occ / 1000.0) ** 4) < 1e-12


def test_fpr_bailout():
    with pytest.raises(sketch.KevlarUnsuitableFPRError):
        import random
        rng = random.Random(8)
        tiny = Sketch(ksize=5, tablesize=10)
        tiny.consume(''.join(rng.choice('ACGT') for _ in range(200)))
        if estimate_fpr(tiny) > 0.2:
            raise sketch.KevlarUnsuitableFPRError('FPR too high')


def test_allocate_traits():
    assert allocate(31, 1000, count=True).counter_bits == 8
    assert allocate(31, 1000, count=True, smallcount=True).counter_bits == 4
    assert allocate(31, 1000, count=False).counter_bits == 1
    assert sketch.get_extension(count=True) == ('.ct', '.counttable')
    assert sketch.get_extension(count=True, smallcount=True) == \
        ('.sct', '.smallcounttable')
    assert sketch.get_extension() == ('.nt', '.nodetable')


def test_packed_multi_sample_gather_matches_per_sample():
    """pack_sample_tables + gather_counts_multi must equal per-sample
    gather_counts for any sample count (incl. a partial final word)."""
    import numpy as np
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops

    rng = np.random.default_rng(42)
    for nsamples in (1, 2, 3, 4, 5, 8):
        tables = [jnp.asarray(rng.integers(0, 256, size=(4, 997),
                                           dtype=np.uint8))
                  for _ in range(nsamples)]
        h1 = jnp.asarray(rng.integers(0, 2**32, size=(5, 17),
                                      dtype=np.uint32))
        h2 = jnp.asarray(rng.integers(0, 2**32, size=(5, 17),
                                      dtype=np.uint32) | 1)
        ref = jnp.stack([sketch_ops.gather_counts(t, h1, h2)
                         for t in tables])
        packed = sketch_ops.pack_sample_tables(tables)
        got = sketch_ops.gather_counts_multi(packed, nsamples, h1, h2)
        assert got.dtype == ref.dtype
        assert np.array_equal(np.asarray(got), np.asarray(ref))


def test_packed_counter_storage_matches_host():
    """1/4-bit sketches store bit-packed rows on device (khmer memory
    parity) and must agree with the unpacked host backend bit-for-bit,
    including saturation and the packed save/load roundtrip."""
    import numpy as np
    from kevlar_tpu.ops import sketch_ops

    rng = np.random.default_rng(11)
    seqs = [''.join(rng.choice(list('ACGT'), 60)) for _ in range(20)]
    for bits in (1, 4, 8):
        dev = Sketch(21, 499, 4, counter_bits=bits)
        host = Sketch(21, 499, 4, counter_bits=bits, backend='host')
        assert dev.tables.shape[1] == sketch_ops.packed_width(499, bits)
        for s in seqs * 2:
            dev.consume(s)
            host.consume(s)
        assert np.array_equal(dev._host(), host.tables)
        for s in seqs[:4]:
            assert dev.get_kmer_counts(s) == host.get_kmer_counts(s)


def test_consume_hashes_planar_subbyte_exact():
    """The per-batch consume (_consume_hashes, behind consume_batch and the
    filter recount) keeps sub-byte rows in the PLANAR layout; the planar
    index remap must be a bijection, preserve saturation, and leave the pad
    nibble/bits of an odd tablesize untouched."""
    import numpy as np
    import jax.numpy as jnp
    from kevlar_tpu.ops import sketch_ops, hashing

    rng = np.random.default_rng(5)
    n = 512
    h1 = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    h2 = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    valid = jnp.asarray(rng.random(n) < 0.9)
    for bits, maxc, tablesize in ((4, 15, 101), (1, 1, 101), (8, 255, 101)):
        ntables = 3
        width = sketch_ops.packed_width(tablesize, bits)
        tables = jnp.zeros((ntables, width), jnp.uint8)
        new = sketch_ops._consume_hashes(tables, h1, h2, valid, maxc,
                                         bits, tablesize)
        # duplicate hashes saturate, so consume twice through the kernel too
        new2 = sketch_ops._consume_hashes(new, h1, h2, valid, maxc,
                                          bits, tablesize)
        vmask = np.asarray(valid)
        for t in range(ntables):
            idx = np.asarray(hashing.table_index(h1, h2, t, tablesize))
            exp = np.zeros(tablesize, np.int64)
            np.add.at(exp, idx[vmask], 1)
            for rounds, got_tables in ((1, new), (2, new2)):
                got = np.asarray(sketch_ops.unpack_counter_row(
                    got_tables[t], bits, tablesize))
                assert np.array_equal(got, np.minimum(rounds * exp, maxc))


@pytest.mark.parametrize('packed_wire', [False, True],
                         ids=['raw-bases', '2bit-wire'])
@pytest.mark.parametrize('bits', [8, 4, 1])
def test_stacked_consume_matches_host_backend(bits, packed_wire):
    """The stacked consume count.py runs (int32 accumulator over a scan of
    batches, saturated once per stack) equals Sketch(backend='host') at
    every counter width, over stacks with duplicate k-mers past the
    saturation point and an odd tablesize."""
    from kevlar_tpu.batch import pack_bases
    from kevlar_tpu.ops import sketch_ops

    rng = np.random.default_rng(bits)
    NB, B, L, k, tablesize = 3, 16, 48, 15, 1001
    stack = rng.integers(0, 4, size=(NB, B, L), dtype=np.uint8)
    stack[:, :14] = stack[0, 0]         # 42 copies of one read per stack
    stack[1, 15, 20] = 4                # an N drops the windows over it
    dev = Sketch(k, tablesize, 4, counter_bits=bits)
    host = Sketch(k, tablesize, 4, counter_bits=bits, backend='host')
    for _ in range(7):                  # 294 copies: past every maxcount
        if packed_wire:
            packed, bad = pack_bases(stack)
            dev.tables = sketch_ops.consume_batch_stack_packed(
                dev.tables, packed, bad, L=L, ksize=k,
                maxcount=dev.maxcount, counter_bits=bits,
                tablesize=tablesize)
            dev._invalidate()
        else:
            dev.consume_batch_stack(stack)
        host.consume_batch_stack(stack)
    assert host.tables.max() == dev.maxcount
    np.testing.assert_array_equal(dev._host(), host.tables)


def test_process_cache_serves_just_saved_sketch(tmp_path):
    """A sketch counted and saved by this process is served from the
    in-process cache on load (no disk round-trip); an externally
    rewritten file invalidates it."""
    import numpy as np
    from kevlar_tpu import count as count_mod
    from kevlar_tpu import sketch as sketch_mod

    fq = tmp_path / 'r.fq'
    seq = 'ACGTTGCAACGTTGCAACGTTGCAGGTCAAGGTCA'
    fq.write_text('@r1\n{}\n+\n{}\n'.format(seq, 'I' * len(seq)))
    out = str(tmp_path / 'r.ct')
    sk = count_mod.load_sample_seqfile([str(fq)], 21, 4e6, outfile=out)
    assert sketch_mod.load(out) is sk

    # external rewrite -> cache drops, fresh object loads
    sk2 = count_mod.load_sample_seqfile([str(fq)], 21, 4e6)
    sk2.save(out)
    import os, time
    os.utime(out, (time.time() + 5, time.time() + 5))
    loaded = sketch_mod.load(out)
    assert loaded is not sk
    assert np.array_equal(loaded._host(), sk2._host())


def test_occupancy_packed_odd_tablesizes():
    """The device occupancy reduction must match the host mirror count for
    sub-byte tables whose size is not a multiple of the pack factor."""
    import numpy as np
    from kevlar_tpu.ops import sketch_ops
    from kevlar_tpu.sketch import Sketch

    rng = np.random.default_rng(12)
    bases = rng.integers(0, 4, size=(8, 64)).astype(np.uint8)
    for bits, size in ((8, 4099), (4, 4101), (1, 4103)):
        sk = Sketch(21, size, 4, counter_bits=bits)
        sk.consume_batch(bases)
        got = int(sketch_ops.occupancy_packed(sk.tables, bits,
                                              sk.tablesize))
        want = int(np.count_nonzero(sk._host()[0]))
        assert got == want, (bits, size, got, want)
