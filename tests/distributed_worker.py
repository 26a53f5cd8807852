"""Worker process for the multi-process (multi-host analog) sharded test.

Usage: python -m tests.distributed_worker PROCESS_ID NUM_PROCESSES PORT OUTDIR

Each process contributes 4 CPU devices; the global ('data', 'shard') mesh
spans all processes, so the sharded-sketch collectives cross the process
boundary exactly as they would cross the network between hosts.  Process 0 writes
the gathered counts to OUTDIR/counts.npy.
"""

import sys


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 4)
    jax.distributed.initialize('localhost:' + port, num_processes=nproc,
                               process_id=pid)
    import numpy as np
    from kevlar_tpu import dna
    from kevlar_tpu.parallel import make_mesh, ShardedSketch

    devices = jax.devices()
    assert len(devices) == 4 * nproc, devices
    mesh = make_mesh(n_data=2, n_shard=2 * nproc, devices=devices)

    rng = np.random.default_rng(7)  # identical data on every process
    seqs = [''.join(np.random.default_rng(100 + i).choice(
        list('ACGT'), size=60)) for i in range(16)]
    bases, _ = dna.encode_batch(seqs)

    sk = ShardedSketch(mesh, 21, 50021)
    sk.consume_batch(bases)
    from jax.experimental import multihost_utils
    import jax.numpy as jnp
    # query via the SPMD program, then gather the (device-spanning) result
    q = sk._query_fn()
    counts_g, valid_g = q(sk.tables, jnp.asarray(bases))
    counts = multihost_utils.process_allgather(counts_g, tiled=True)
    valid = multihost_utils.process_allgather(valid_g, tiled=True)

    if pid == 0:
        np.save(outdir + '/counts.npy', counts)
        np.save(outdir + '/valid.npy', valid)
        with open(outdir + '/meta.txt', 'w') as fh:
            fh.write('{} {} {}\n'.format(len(devices), sk.tablesize,
                                         counts.shape))
    jax.distributed.shutdown()


if __name__ == '__main__':
    main()
