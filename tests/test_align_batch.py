"""Batched device (wavefront/vmap) aligner: exact parity with the scalar."""

import random

import pytest

from kevlar_tpu.ops.align import align_scalar
from kevlar_tpu.ops.align_ops import align_batch

from . import simdata


def test_batch_aligner_parity_related_pairs():
    rng = random.Random(4040)
    targets, queries, expected = [], [], []
    for _ in range(16):
        g = simdata.make_genome(rng, rng.randint(60, 200))
        a = rng.randint(0, len(g) // 3)
        b = rng.randint(2 * len(g) // 3, len(g))
        q = g[a:b]
        kind = rng.choice(['none', 'snv', 'ins', 'del'])
        if kind == 'snv' and len(q) > 10:
            q, _, _ = simdata.apply_snv(q, rng.randint(0, len(q) - 1),
                                        rng=rng)
        elif kind == 'ins' and len(q) > 10:
            q = simdata.apply_insertion(
                q, rng.randint(1, len(q) - 1), simdata.make_genome(rng, 6))
        elif kind == 'del' and len(q) > 30:
            q = simdata.apply_deletion(q, rng.randint(1, len(q) - 12), 8)
        targets.append(g)
        queries.append(q)
        expected.append(align_scalar(g, q))
    got = align_batch(targets, queries)
    assert got == expected


def test_batch_aligner_mixed_lengths():
    rng = random.Random(4141)
    targets = [simdata.make_genome(rng, n) for n in (30, 61, 127, 200)]
    queries = [t[5:-5] for t in targets]
    got = align_batch(targets, queries)
    for (cig, score), t, q in zip(got, targets, queries):
        assert (cig, score) == align_scalar(t, q)


def test_mesh_sharded_align_matches_host():
    """Sharding the alignment batch axis across the 8-device CPU mesh must
    give (score, cigar, strand) identical to the host scalar aligner —
    the sharded call path's correctness pin (the device analog of the
    reference's N parallel call shards, Snakefile:345-356)."""
    import random
    from kevlar_tpu.dna import revcom
    from kevlar_tpu.ops.align import align_both_strands_batch
    from kevlar_tpu.parallel import make_mesh

    rng = random.Random(99)
    pairs = []
    for i in range(13):   # deliberately not a multiple of the device count
        tlen = rng.choice((80, 150, 300))
        target = ''.join(rng.choice('ACGT') for _ in range(tlen))
        # query: a mutated window of the target, sometimes revcom
        lo = rng.randrange(0, tlen // 2)
        q = list(target[lo:lo + tlen // 2 + 10])
        q[len(q) // 2] = 'A' if q[len(q) // 2] != 'A' else 'C'
        query = ''.join(q)
        if i % 3 == 0:
            query = revcom(query)
        pairs.append((target, query))

    host = align_both_strands_batch(pairs)            # host loop on CPU
    mesh = make_mesh(n_data=8, n_shard=1)
    sharded = align_both_strands_batch(pairs, mesh=mesh, group_buckets=True)
    assert host == sharded


def test_align_partitions_matches_per_partition_call():
    """The global cross-partition alignment batch must hand every
    partition exactly the strandings its own per-partition dispatch would
    compute."""
    import random
    from kevlar_tpu import call as call_mod
    from kevlar_tpu.ops.align import align_both_strands_batch
    from kevlar_tpu.parallel import make_mesh

    rng = random.Random(7)

    class FakeCutout:
        def __init__(self, name, seq):
            self.defline = name
            self.sequence = seq

        def __len__(self):
            return len(self.sequence)

    class FakeContig:
        def __init__(self, name, seq):
            self.name = name
            self.sequence = seq

        def __len__(self):
            return len(self.sequence)

    jobs_by_part = {}
    for pid in ('1', '2', '3'):
        genome = ''.join(rng.choice('ACGT') for _ in range(400))
        targets = [FakeCutout('chr1_{}-400'.format(i), genome[i:i + 220])
                   for i in (0, 90)]
        q = list(genome[40:40 + 160])
        q[80] = 'A' if q[80] != 'A' else 'G'
        queries = [FakeContig('contig{}'.format(pid), ''.join(q))]
        _, _, _, jobs = call_mod.partition_jobs(targets, queries)
        jobs_by_part[pid] = jobs

    mesh = make_mesh(n_data=8, n_shard=1)
    got = call_mod.align_partitions(jobs_by_part, mesh=mesh)
    for pid, jobs in jobs_by_part.items():
        expect = align_both_strands_batch(jobs)
        assert got[pid] == expect, pid


def test_big_batches_chunk_within_memory_budget(monkeypatch):
    """A whole-run global batch must split into budget-capped dispatches
    (the [B, T+Q-1, T] direction tensor would otherwise exceed HBM) with
    results identical to the unchunked program."""
    import random
    from kevlar_tpu.ops import align_ops

    rng = random.Random(21)
    pairs = []
    for _ in range(40):
        t = ''.join(rng.choice('ACGT') for _ in range(120))
        q = list(t[10:110])
        q[50] = 'A' if q[50] != 'A' else 'C'
        pairs.append((t, ''.join(q)))
    ts = [t for t, _ in pairs]
    qs = [q for _, q in pairs]

    full = align_ops.align_batch(ts, qs)
    # budget that forces bmax=8 -> five chunks
    monkeypatch.setattr(align_ops, '_ZDIAG_BUDGET_BYTES',
                        16 * (128 + 128 - 1) * 128)
    chunked = align_ops.align_batch(ts, qs)
    assert chunked == full


def test_batch_cigar_decode_matches_scalar_reference():
    """_cigars_from_ops_batch (vectorised RLE) must emit exactly what the
    per-step _cigar_from_ops loop emits, including leading-gap merges and
    empty/all-inactive rows."""
    import numpy as np
    from kevlar_tpu.ops.align_ops import (_cigar_from_ops,
                                          _cigars_from_ops_batch)
    rng = np.random.default_rng(20260821)
    B, S = 256, 64
    ops = np.full((B, S), 3, dtype=np.uint8)
    for b in range(B):
        n = int(rng.integers(0, S + 1))
        # runs of ops 0/1/2 (monotone-inactive 3 tail)
        pos = 0
        while pos < n:
            run = int(rng.integers(1, 9))
            ops[b, pos:pos + run] = int(rng.integers(0, 3))
            pos += run
        ops[b, n:] = 3
    exit_i = rng.integers(-1, 5, size=B).astype(np.int32)
    exit_j = rng.integers(-1, 5, size=B).astype(np.int32)
    got = _cigars_from_ops_batch(ops, exit_i, exit_j)
    for b in range(B):
        want = _cigar_from_ops(ops[b], int(exit_i[b]), int(exit_j[b]))
        assert got[b] == want, (b, got[b], want)


def test_unknown_align_engine_is_refused(monkeypatch):
    """A removed or misspelt KEVLAR_ALIGN_BACKEND fails at start-up with
    the list of engines that exist."""
    from kevlar_tpu.ops import align
    monkeypatch.setenv('KEVLAR_ALIGN_BACKEND', 'pallas')
    with pytest.raises(ValueError, match="'pallas'; expected one of "
                                         'native, numpy, scalar, device'):
        align._pick_default()


def test_batch_engine_is_chosen_per_platform(monkeypatch):
    """Unset, the batched-alignment engine is the measured choice for the
    JAX platform; a platform nobody measured is an error, not a default;
    KEVLAR_ALIGN_BACKEND overrides either way."""
    import jax
    from kevlar_tpu.ops import align
    monkeypatch.delenv('KEVLAR_ALIGN_BACKEND', raising=False)
    assert align._use_device_batch() is \
        align._DEVICE_BATCH_BY_PLATFORM['cpu']
    monkeypatch.setattr(jax, 'default_backend', lambda: 'rocm')
    with pytest.raises(ValueError, match="platform 'rocm'"):
        align._use_device_batch()
    monkeypatch.setenv('KEVLAR_ALIGN_BACKEND', 'device')
    assert align._use_device_batch() is True
    monkeypatch.setenv('KEVLAR_ALIGN_BACKEND', 'native')
    assert align._use_device_batch() is False
