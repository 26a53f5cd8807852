"""Device-side exact seed-index search for the localizer.

The localizer's seed matching (the reference's ``bwa mem -k s -T s -a``
subprocess, /root/reference/kevlar/localize.py:131-144) is an exact lookup
of canonical seed codes against every seed-sized window of the reference
genome.  The host path (:class:`kevlar_tpu.reference.SeedIndex`) keeps the
sorted 64-bit fold keys in RAM and binary-searches with numpy.  This module
provides the device path for *very large references*: the sorted key array
lives in device memory as two uint32 planes (hi/lo words — JAX runs
without 64-bit integers by default) and queries are answered by a vectorised lexicographic binary
search, one fused jit dispatch for the whole seed batch.

For references beyond a single chip's HBM, :func:`seed_ranges_sharded`
shards the key array over the 'shard' axis of a ('data', 'shard') mesh —
each device searches its contiguous key range and the global match range is
reconstructed with ``pmin``/``psum`` collectives, mirroring the sharded
Count-Min sketch design (`kevlar_tpu/parallel/sharded.py`).  Equal-key runs
may straddle shard boundaries; since shards are contiguous chunks of the
globally sorted array, summing per-shard counts and taking the minimum
global start index is exact.
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


def _less(ahi, alo, bhi, blo):
    """Lexicographic (ahi, alo) < (bhi, blo) on uint32 words."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def _searchsorted2(hi_keys, lo_keys, qhi, qlo, side, n_valid):
    """Vectorised lexicographic searchsorted over (hi, lo) uint32 pairs.

    ``hi_keys``/``lo_keys`` are the two words of a lexicographically sorted
    uint64 key array (padding, if any, must sort last and lie at indices
    >= n_valid).  Returns, per query, the insertion point within
    [0, n_valid] for the requested ``side``.
    """
    n = hi_keys.shape[0]
    # derive both carries from qhi so their varying-axis types match under
    # shard_map (a fresh jnp.zeros would be unvarying, n_valid varying)
    lo = (qhi & jnp.uint32(0)).astype(jnp.int32)
    hi = lo + jnp.asarray(n_valid, jnp.int32)
    steps = max(1, int(n).bit_length() + 1)

    def body(_, state):
        lo, hi = state
        active = lo < hi
        mid = jnp.clip((lo + hi) >> 1, 0, n - 1)
        khi = hi_keys[mid]
        klo = lo_keys[mid]
        if side == 'left':
            go_right = _less(khi, klo, qhi, qlo)
        else:
            go_right = ~_less(qhi, qlo, khi, klo)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, hi = lax.fori_loop(0, steps, body, (lo, hi))
    return lo


@functools.partial(jax.jit, static_argnames=())
def seed_ranges(hi_keys, lo_keys, qhi, qlo):
    """Match ranges of query keys in a sorted key array (single device).

    Returns (start, count) int32 arrays, one entry per query: the global
    index of the first matching key and the number of matches.
    """
    n_valid = hi_keys.shape[0]
    left = _searchsorted2(hi_keys, lo_keys, qhi, qlo, 'left', n_valid)
    right = _searchsorted2(hi_keys, lo_keys, qhi, qlo, 'right', n_valid)
    return left, right - left


@functools.lru_cache(maxsize=8)
def _sharded_range_search(mesh):
    """Build (once per mesh) the jitted sharded binary-search program.

    Cached so every SeedIndex.lookup batch reuses one compiled program —
    re-wrapping shard_map per call would retrace and recompile each time
    (jit caches key on function identity), defeating the power-of-two
    query padding that exists to bound recompiles.
    """

    def local_search(hk, lk, nv, qh, ql):
        nv = nv.reshape(())
        # queries are replicated; mark them shard-varying so the binary
        # search carry (which mixes them with the shard-local n_valid)
        # type-checks under shard_map
        try:
            qh = lax.pcast(qh, ('shard',), to='varying')
            ql = lax.pcast(ql, ('shard',), to='varying')
        except AttributeError:  # older jax without explicit vma typing
            pass
        left = _searchsorted2(hk, lk, qh, ql, 'left', nv)
        right = _searchsorted2(hk, lk, qh, ql, 'right', nv)
        cnt = right - left
        count = lax.psum(cnt, 'shard')
        # first shard holding a match, and the local offset within it;
        # the (int64) global index is reconstructed on the host so key
        # arrays beyond 2^31 entries don't overflow 32-bit device lanes
        rank = (cnt & 0) + lax.axis_index('shard')
        nohit = jnp.int32(2**31 - 1)
        first = lax.pmin(jnp.where(cnt > 0, rank, nohit), 'shard')
        local = lax.pmin(
            jnp.where((cnt > 0) & (rank == first), left, nohit), 'shard')
        return first, local, count

    fn = shard_map(
        local_search, mesh=mesh,
        in_specs=(P('shard'), P('shard'), P('shard'), P(), P()),
        out_specs=(P(), P(), P()))
    return jax.jit(fn)


def seed_ranges_sharded(mesh, hi_keys, lo_keys, qhi, qlo, n_valid, base):
    """Match ranges against a 'shard'-axis-sharded sorted key array.

    ``hi_keys``/``lo_keys``: [n_shard * cap] globally sorted keys, each
    shard padded to 0xFFFFFFFF sentinels. ``n_valid``: [n_shard] device
    array of per-shard valid counts; ``base``: [n_shard] *host* int64
    array of each shard's global start offset. Queries are replicated.
    Returns numpy (start int64, count int32) in global unpadded index
    space; start is INT64_MAX where count == 0 (human-genome-scale
    indexes exceed int32, so the global index math stays on the host).
    """
    first, local, count = _sharded_range_search(mesh)(
        hi_keys, lo_keys, n_valid, qhi, qlo)
    first = np.asarray(first)
    local = np.asarray(local)
    count = np.asarray(count)
    base = np.asarray(base, dtype=np.int64)
    start = np.full(first.shape, np.iinfo(np.int64).max, dtype=np.int64)
    hit = count > 0
    start[hit] = base[first[hit]] + local[hit].astype(np.int64)
    return start, count


def shard_keys(keys, n_shard):
    """Split a sorted uint64 key array into sharded device planes.

    Returns (hi, lo, n_valid, base) numpy arrays ready for
    :func:`seed_ranges_sharded`: hi/lo are [n_shard * cap] uint32 with
    sentinel padding per shard, n_valid is [n_shard] int32, and base is
    [n_shard] int64 (global offsets can exceed int32 for genome-scale
    indexes — it stays host-side).
    """
    n = len(keys)
    cap = max(1, -(-n // n_shard))
    hi = np.full(n_shard * cap, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(n_shard * cap, 0xFFFFFFFF, dtype=np.uint32)
    n_valid = np.zeros(n_shard, dtype=np.int32)
    base = np.zeros(n_shard, dtype=np.int64)
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    klo = keys.astype(np.uint32)
    for s in range(n_shard):
        a, b = s * cap, min((s + 1) * cap, n)
        m = max(0, b - a)
        hi[s * cap:s * cap + m] = khi[a:a + m]
        lo[s * cap:s * cap + m] = klo[a:a + m]
        n_valid[s] = m
        base[s] = a
    return hi, lo, n_valid, base


def split_words(keys):
    """uint64 keys -> (hi, lo) uint32 planes."""
    keys = np.asarray(keys, dtype=np.uint64)
    return ((keys >> np.uint64(32)).astype(np.uint32),
            keys.astype(np.uint32))
