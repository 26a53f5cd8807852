"""Multi-process (multi-host analog) sharded execution.

Spawns two OS processes, each contributing 4 CPU devices to one global
('data', 'shard') mesh; the sharded sketch's psum/pmin collectives cross the
process boundary (Gloo, standing in for a multi-host network).  Counts must be
bit-identical to a single-device sketch of the same tablesize.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from . import simdata  # noqa: F401  (import keeps test pkg layout uniform)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_sharded_counts(tmp_path):
    port = '2961' + str(os.getpid() % 10)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    # workers force platform/devices themselves via jax.config
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'tests.distributed_worker', str(pid), '2',
         port, str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL) for pid in (0, 1)]
    for p in procs:
        assert p.wait(timeout=180) == 0

    counts = np.load(str(tmp_path / 'counts.npy'))
    valid = np.load(str(tmp_path / 'valid.npy'))
    meta = open(str(tmp_path / 'meta.txt')).read().split()
    assert meta[0] == '8'          # 2 processes x 4 devices
    tablesize = int(meta[1])

    # single-device reference with the same (shard-padded) tablesize
    from kevlar_tpu import dna
    from kevlar_tpu.sketch import Sketch
    seqs = [''.join(np.random.default_rng(100 + i).choice(
        list('ACGT'), size=60)) for i in range(16)]
    bases, _ = dna.encode_batch(seqs)
    single = Sketch(21, tablesize, 4, counter_bits=8)
    single.consume_batch(bases)
    h1, h2, v = dna.kmer_hashes(bases, 21)
    expected = single._host_counts(h1, h2, v)
    np.testing.assert_array_equal(counts, expected)
    np.testing.assert_array_equal(valid, v)
