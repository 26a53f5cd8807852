"""Multi-device (SPMD) execution: sharded sketches over a jax Mesh.

The reference scales with k-mer *banding* — N serial passes over the data,
each counting 1/N of the hash space, merged by ``unband``
(reference docs/banding.rst).  The device design makes the band
dimension a mesh axis instead: the Count-Min sketch is hash-range-sharded
across devices ('shard' axis), read batches are data-parallel ('data' axis),
count increments all-reduce over 'data', and lookups min-reduce over 'shard'
— one pass, collectives between devices instead of N-fold re-runs.
"""

from kevlar_tpu.parallel.mesh import (make_mesh, device_grid,
                                      init_distributed)
from kevlar_tpu.parallel.sharded import ShardedSketch, sharded_novel_screen
