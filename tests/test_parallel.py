"""Multi-device sharded sketch: equivalence with the single-device engine.

Runs on the virtual 8-device CPU mesh (conftest).  The contract: a sketch
hash-sharded over N devices produces the same counts and the same novel
screen as the single-device sketch — the SPMD analog of the reference's
band-merge equivalence tests.
"""

import random

import numpy as np
import pytest

import jax

from kevlar_tpu import dna
from kevlar_tpu.batch import batches_from_records
from kevlar_tpu.parallel import make_mesh, ShardedSketch, sharded_novel_screen
from kevlar_tpu.sketch import Sketch

from . import simdata

KSIZE = 21
TABLESIZE = 100003


@pytest.fixture(scope='module')
def seqs():
    rng = random.Random(123)
    return [simdata.make_genome(rng, 80) for _ in range(32)]


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize('n_data,n_shard', [(1, 8), (2, 4), (8, 1)])
def test_sharded_counts_match_single_device(seqs, n_data, n_shard):
    mesh = make_mesh(n_data, n_shard)
    bases, _ = dna.encode_batch(seqs)

    sharded = ShardedSketch(mesh, KSIZE, TABLESIZE)
    sharded.consume_batch(bases)

    single = Sketch(KSIZE, sharded.tablesize, 4, counter_bits=8)
    single.consume_batch(bases)

    counts_sh, valid_sh = sharded.query_batch(bases)
    h1, h2, valid = dna.kmer_hashes(bases, KSIZE)
    counts_single = single._host_counts(h1, h2, valid)
    np.testing.assert_array_equal(counts_sh, counts_single)
    np.testing.assert_array_equal(valid_sh, valid)


def test_sharded_novel_screen_matches_unsharded(seqs):
    rng = random.Random(321)
    genome = simdata.make_genome(rng, 1000)
    child_genome, _, _ = simdata.apply_snv(genome, 500, rng=rng)
    child = simdata.tiled_reads(child_genome, 100, 10, 'c')
    parent = simdata.tiled_reads(genome, 100, 10, 'p')
    cb, _ = dna.encode_batch([r.sequence for r in child])
    pb, _ = dna.encode_batch([r.sequence for r in parent])
    lengths = np.full(len(child), 100, np.int32)

    mesh = make_mesh(2, 4)
    case_sh = ShardedSketch(mesh, KSIZE, TABLESIZE)
    ctrl_sh = ShardedSketch(mesh, KSIZE, TABLESIZE)
    case_sh.consume_batch(cb)
    ctrl_sh.consume_batch(pb)

    interesting, abunds, discard, skip = sharded_novel_screen(
        mesh, [case_sh], [ctrl_sh], cb, lengths, casemin=6, ctrlmax=0)

    # single-device reference
    case = Sketch(KSIZE, case_sh.tablesize, 4, counter_bits=8)
    ctrl = Sketch(KSIZE, ctrl_sh.tablesize, 4, counter_bits=8)
    case.consume_batch(cb)
    ctrl.consume_batch(pb)
    from kevlar_tpu.ops.novel_ops import novel_screen
    import jax.numpy as jnp
    ref_int, ref_ab, ref_disc, ref_skip = novel_screen(
        (case.tables,), (ctrl.tables,), jnp.asarray(cb),
        jnp.asarray(lengths), ksize=KSIZE, casemin=6, ctrlmax=0)
    np.testing.assert_array_equal(interesting, np.asarray(ref_int))
    np.testing.assert_array_equal(abunds, np.asarray(ref_ab))
    np.testing.assert_array_equal(skip, np.asarray(ref_skip))


def test_sharded_end_to_end_novel_stage(tmp_path):
    """count(mesh=...) + novel() over sharded sketches == single-device."""
    from kevlar_tpu.count import load_sample_seqfile
    from kevlar_tpu.novel import novel
    rng = random.Random(777)
    genome = simdata.make_genome(rng, 1200)
    child_genome, _, _ = simdata.apply_snv(genome, 600, rng=rng)
    child = simdata.tiled_reads(child_genome, 100, 10, 'c')
    parent = simdata.tiled_reads(genome, 100, 10, 'p')
    childfq = str(tmp_path / 'child.fq')
    parentfq = str(tmp_path / 'parent.fq')
    simdata.write_fastq(child, childfq)
    simdata.write_fastq(parent, parentfq)

    mesh = make_mesh(2, 4)
    case_sh = load_sample_seqfile([childfq], KSIZE, 4e6, mesh=mesh)
    ctrl_sh = load_sample_seqfile([parentfq], KSIZE, 4e6, mesh=mesh)
    out_sh = list(novel(iter(child), [case_sh], [ctrl_sh], ksize=KSIZE,
                        casemin=6, ctrlmax=0))

    case_sg = load_sample_seqfile([childfq], KSIZE, 4e6)
    ctrl_sg = load_sample_seqfile([parentfq], KSIZE, 4e6)
    # tablesize differs (shard padding), so compare the *screen results*
    out_sg = list(novel(iter(child), [case_sg], [ctrl_sg], ksize=KSIZE,
                        casemin=6, ctrlmax=0))

    ann_sh = {(r.name, k.offset, k.abund) for r in out_sh
              for k in r.annotations}
    ann_sg = {(r.name, k.offset, k.abund) for r in out_sg
              for k in r.annotations}
    assert len(ann_sh) > 0
    assert ann_sh == ann_sg

    # save/load roundtrip of the sharded sketch
    path = str(tmp_path / 'case.ct')
    case_sh.save(path)
    from kevlar_tpu import sketch as sketch_mod
    loaded = sketch_mod.load(path)
    kmer = child_genome[590:590 + KSIZE]
    assert loaded.get(kmer) == case_sh.get(kmer)


def test_sharded_packed_counters_match_host():
    """Sub-byte sharded sketches keep per-shard bit-packed rows and must
    agree with the unpacked single-device host backend."""
    import numpy as np
    from kevlar_tpu.parallel import make_mesh, ShardedSketch
    from kevlar_tpu.sketch import Sketch
    from kevlar_tpu import dna

    mesh = make_mesh(n_data=2, n_shard=4)
    rng = np.random.default_rng(4)
    bases = rng.integers(0, 4, size=(16, 64)).astype(np.uint8)
    for bits in (1, 4):
        sh = ShardedSketch(mesh, 21, 4096, counter_bits=bits)
        single = Sketch(21, sh.tablesize, 4, counter_bits=bits,
                        backend='host')
        sh.consume_batch(bases)
        single.consume_batch(bases)
        assert sh.tables.shape[1] * {1: 8, 4: 2}[bits] == sh.tablesize
        assert np.array_equal(sh._host(), single.tables)
        counts, valid = sh.query_batch(bases)
        h1, h2, v = dna.kmer_hashes(bases, 21)
        expected = np.where(v, single._host_counts(h1, h2), 0)
        assert np.array_equal(counts, expected.astype(np.uint8))
        # sub-byte bucket recovery in occupied(): device n_occupied must
        # agree with the host sketch (guards the planar-unpack index math)
        assert sh.n_occupied() == single.n_occupied()


@pytest.mark.parametrize('bits', [1, 4, 8])
def test_routed_consume_matches_replicate(bits):
    """The hash-routed (all_to_all) consume and the replicate-and-drop
    fallback must produce bit-identical tables, and both must match the
    single-device host engine."""
    from kevlar_tpu.parallel import make_mesh, ShardedSketch
    from kevlar_tpu.sketch import Sketch

    mesh = make_mesh(n_data=2, n_shard=4)
    rng = np.random.default_rng(11)
    bases = rng.integers(0, 4, size=(24, 70)).astype(np.uint8)
    bases[3, 50:] = 4  # ambiguous tail: valid-mask interplay

    routed = ShardedSketch(mesh, KSIZE, 4096, counter_bits=bits)
    routed.consume_batch(bases, route='alltoall')
    repl = ShardedSketch(mesh, KSIZE, 4096, counter_bits=bits)
    repl.consume_batch(bases, route='replicate')
    host = Sketch(KSIZE, routed.tablesize, 4, counter_bits=bits,
                  backend='host')
    host.consume_batch(bases)

    np.testing.assert_array_equal(routed._host(), repl._host())
    np.testing.assert_array_equal(routed._host(), host.tables)


def test_routed_consume_overflow_falls_back():
    """A batch whose k-mers all hash to one shard (every read identical)
    overflows a tiny routing capacity; the batch must transparently re-run
    down the replicate path with identical counts."""
    from kevlar_tpu.parallel import make_mesh, ShardedSketch
    from kevlar_tpu.sketch import Sketch

    mesh = make_mesh(n_data=2, n_shard=4)
    one = np.tile(np.array([0, 1, 2, 3], np.uint8), 16)[:60]
    bases = np.tile(one, (16, 1))  # 16 copies of one read

    sh = ShardedSketch(mesh, KSIZE, 4096)
    sh.consume_batch(bases, route='alltoall', a2a_capacity=8)
    host = Sketch(KSIZE, sh.tablesize, 4, backend='host')
    host.consume_batch(bases)
    np.testing.assert_array_equal(sh._host(), host.tables)


@pytest.mark.slow
def test_sharded_sketch_at_scale_proxy():
    """Human-scale memory exercise, scaled to the CPU mesh: a 512 MB-class
    hash space sharded 8 ways must place exactly 1/8 of the (packed) table
    on each device, never gather to the host, and count/query correctly.

    Sizing contract being modeled (docs/sharding.md): the reference
    recommends 10-20 GB/sample sketches for human 30x WGS
    (reference docs/tutorial.rst:51); on an 80 GB card (60 GB for JAX)
    that is one device per sample, and a 72 GB uncorrected-read sketch
    shards over 2 or more.
    This proxy keeps the same shards-of-one-table structure at 1/128
    scale so the test fits CI RAM.
    """
    import jax
    import numpy as np
    from kevlar_tpu import dna
    from kevlar_tpu.parallel import make_mesh, ShardedSketch

    mesh = make_mesh(n_data=1, n_shard=8)
    total = 512 * 1024 * 1024 // 128        # 4 Mbuckets -> 8-bit = 4 MB/table
    sk = ShardedSketch(mesh, 31, total, ntables=4, counter_bits=8)
    # one shard of every table row lives on each device
    shards = sk.tables.addressable_shards
    assert len(shards) == 8
    per_dev = {s.device: s.data.shape for s in shards}
    assert len(per_dev) == 8
    for shape in per_dev.values():
        assert shape == (4, sk.shard_width)
    # consume + query round-trip without any host gather
    rng = np.random.default_rng(5)
    seqs = [''.join(rng.choice(list('ACGT'), size=100)) for _ in range(64)]
    bases, lengths = dna.encode_batch(seqs)
    sk.consume_batch(bases)
    counts, valid = sk.query_batch(bases)
    assert (np.asarray(counts)[np.asarray(valid)] >= 1).all()
    assert getattr(sk, '_host_tables', None) is None
