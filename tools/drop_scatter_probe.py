"""Does XLA's scatter-add charge for dropped (out-of-bounds) indices?

The masked count screens out most k-mers (reads are overwhelmingly
reference sequence).  Historically the consume kernel scattered ALL
indices with an increment of 0 for screened-out k-mers — paying the
~13-cycle serialized RMW for work that changes nothing.  The kernel now
routes screened-out k-mers to an out-of-bounds index under
``mode='drop'``; this probe measures whether the hardware actually skips
them (per-element scatter cost vs per-surviving-element cost).

Prints one JSON line with updates/s for 0%, 50%, 80%, and 95% dropped.

Usage:  python tools/drop_scatter_probe.py            # default JAX backend
        KEVLAR_PLATFORM=cpu python tools/drop_scatter_probe.py
"""

import functools
import json
import os
import sys
import time

import numpy as np

if os.environ.get('KEVLAR_PLATFORM'):
    os.environ['JAX_PLATFORMS'] = os.environ['KEVLAR_PLATFORM']
    if 'jax' in sys.modules:
        sys.modules['jax'].config.update('jax_platforms',
                                         os.environ['KEVLAR_PLATFORM'])

import jax
import jax.numpy as jnp

N = 15_728_640          # index-stream length (the consume probe's shape)
TABLESIZE = 25_000_000  # one table row of the helium-size sketch


@functools.partial(jax.jit, donate_argnames=('acc',))
def scatter(acc, idx):
    return acc.at[idx].add(1, mode='drop')


def run(drop_frac, reps=5):
    rng = np.random.default_rng(42)
    idx = rng.integers(0, TABLESIZE, size=N).astype(np.int32)
    ndrop = int(drop_frac * N)
    if ndrop:
        sel = rng.choice(N, size=ndrop, replace=False)
        idx[sel] = TABLESIZE  # out of bounds -> dropped
    idx = jnp.asarray(idx)
    acc = jnp.zeros((TABLESIZE,), jnp.int32)
    acc = scatter(acc, idx)          # compile + warm
    _ = int(acc[0])                  # force materialisation
    t0 = time.time()
    for _ in range(reps):
        acc = scatter(acc, idx)
    checksum = int(acc[0]) + int(acc[TABLESIZE // 2])
    wall = (time.time() - t0) / reps
    return dict(drop_frac=drop_frac, wall_s=round(wall, 4),
                total_updates_per_s=round(N / wall),
                surviving_updates_per_s=round((N - ndrop) / max(wall, 1e-9)))


def run_size(tablesize, reps=3):
    """Scatter throughput vs table size: is the random RMW rate flat, or
    does it degrade as the target outgrows on-chip locality?  (The bigsim
    count stages ran 5x below the small-table roofline; a size-dependent
    scatter rate would be the hardware-floor explanation.)"""
    rng = np.random.default_rng(1)
    idx = jnp.asarray(rng.integers(0, tablesize, size=N).astype(np.int32))
    acc = jnp.zeros((tablesize,), jnp.int32)
    acc = scatter(acc, idx)
    _ = int(acc[0])
    t0 = time.time()
    for _ in range(reps):
        acc = scatter(acc, idx)
    checksum = int(acc[0]) + int(acc[tablesize // 2])
    wall = (time.time() - t0) / reps
    return dict(tablesize=tablesize, table_mb=round(tablesize * 4 / 1e6),
                wall_s=round(wall, 4), updates_per_s=round(N / wall))


def main():
    # drop fractions share one compiled program
    rows = [run(f) for f in (0.0, 0.8)]
    # int32 accumulator sizes: 100 MB (bench-scale), 500 MB (helium
    # per-table), 1.37 GB (bigsim per-table)
    sizes = [run_size(t) for t in
             (25_000_000, 125_000_000, 343_200_000)]
    print(json.dumps({
        'suite': 'drop_scatter_probe', 'backend': jax.default_backend(),
        'n': N, 'tablesize': TABLESIZE, 'rows': rows,
        'table_size_sweep': sizes,
        'verdict': ('dropped elements are skipped' if
                    rows[-1]['wall_s'] < 0.5 * rows[0]['wall_s'] else
                    'scatter cost is per input element'),
    }))


if __name__ == '__main__':
    main()
