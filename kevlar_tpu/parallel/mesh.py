"""Mesh construction helpers."""

import numpy as np

import jax
from jax.sharding import Mesh


def device_grid(n_data=None, n_shard=None, devices=None):
    """Pick a (data, shard) grid for the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_data is None and n_shard is None:
        # favor sharding the sketch (memory scaling) over data parallelism
        n_shard = n
        n_data = 1
    elif n_data is None:
        n_data = n // n_shard
    elif n_shard is None:
        n_shard = n // n_data
    if n_data * n_shard != n or n_data < 1 or n_shard < 1:
        raise ValueError(
            'cannot build a {}x{} (data x shard) mesh from {} available '
            'device(s); --shards must divide the device count (use '
            'XLA_FLAGS/jax_num_cpu_devices for a virtual CPU mesh)'.format(
                n_data, n_shard, n))
    return n_data, n_shard, devices


def make_mesh(n_data=None, n_shard=None, devices=None):
    """Build a Mesh with ('data', 'shard') axes."""
    n_data, n_shard, devices = device_grid(n_data, n_shard, devices)
    grid = np.array(devices).reshape(n_data, n_shard)
    return Mesh(grid, ('data', 'shard'))


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Initialize multi-host execution.

    Within one host the GPUs talk over NVLink, all to all at one rate, and
    XLA hands the mesh's collectives to NCCL; across hosts NCCL goes over
    the network.  The mesh follows the algorithm, not a physical topology.
    Thin wrapper over ``jax.distributed.initialize``: pass
    ``coordinator_address`` (e.g. ``localhost:<port>``), ``num_processes``
    and ``process_id`` unless a cluster environment supplies them.  After
    initialization, ``make_mesh`` spans every host's devices and the
    sharded pipeline runs unchanged — the mesh program is identical on 1
    host and N hosts.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id, **kwargs)
    return jax.devices()
