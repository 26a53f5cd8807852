"""Multi-device scaling proxy for the sharded consume+screen path.

A CPU-mesh and Gloo proxy: it never runs on the GPU, and its numbers are
CPU timings, not device metrics.  The reference scales with k-mer banding:
N serial passes, each counting 1/N of the hash space
(reference docs/banding.rst:4-6), scattered over processes by
Snakemake.  The device replacement is a hash-sharded sketch over a
('data', 'shard') mesh; this tool exercises that path on virtual CPU
devices:

1. **Shard-axis scaling** (1/2/4/8 virtual CPU devices, one process) at a
   constant total batch (>=64k reads/rep — amortizing sizes, so dispatch
   overhead is noise).  Two consume routes are measured:

   - ``alltoall`` (production default): reads shard over both mesh axes,
     each k-mer is hashed once and routed to its owner shard
     (parallel/sharded.py:_route_consume).  Total compute is CONSTANT in
     n, so on a serialized virtual mesh the ideal wall is flat:
     ``routed_strong_efficiency = wall_1 / wall_n`` (1.0 = no routing
     overhead; on n real devices the same program's per-device wall is
     ~wall_n/n plus collective time).
   - ``replicate`` (fallback): every shard hashes every k-mer and drops
     out-of-range indices — n-fold redundant compute.  Reported with the
     legacy ``serialized_efficiency = n * wall_1 / wall_n`` (1.0 = the
     SPMD program costs no more than n independent single-device runs)
     for continuity with round-3 SCALING.json, plus
     ``alltoall_speedup = wall_replicate / wall_alltoall``.

   The screen (query) path replicates queries across 'shard' and selects
   owners' counts with ``pmin`` — per-device gather work is 1/n of the
   hash work but the gathers dominate; it keeps the legacy
   serialized-efficiency metric.

2. **Data-axis scaling at equal total work**: 1 device vs N devices over
   the SAME batch on this host — isolates the data-parallel partitioning
   overhead from core contention (XLA's CPU backend already multithreads
   a single device across cores, so a throughput "speedup" on virtual
   devices would be meaningless).

3. **Multi-process (Gloo) runs**: the same shard-axis program with the
   mesh spanning 2 x 4 and 4 x 2 OS processes x devices, standing in for
   2/4 hosts; overhead vs the single-process 8-device run is the
   cross-process cost.

Writes SCALING.json next to this script.  For several hosts, run the same
worker under jax.distributed on every host:

    # on every host (coordinator = host 0):
    python tools/scaling_bench.py --worker --ndev 0 --n-data 1 --n-shard 8 \
        --distributed COORD_IP:8476 NPROC PID --out host_scaling.json

(--ndev 0 keeps the real backend: no CPU override.)
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B_TOTAL = 65536   # reads per rep (amortizing: dispatch/marshal << compute)
L = 160           # padded read length
READLEN = 150
KSIZE = 31
SHARD_TABLESIZE = 262144   # buckets per shard (constant: weak memory scaling)
REPS = 2


def worker(ndev, n_data, n_shard, out, distributed=None, bmul=None,
           routes=('alltoall', 'replicate'), screen=True):
    import jax
    if ndev:
        jax.config.update('jax_platforms', 'cpu')
        jax.config.update('jax_num_cpu_devices', ndev)
    if distributed:
        coord, nproc, pid = distributed
        jax.distributed.initialize(coord, num_processes=int(nproc),
                                   process_id=int(pid))
    import numpy as np
    from kevlar_tpu.parallel import make_mesh, ShardedSketch
    from kevlar_tpu.parallel import sharded_novel_screen

    devices = jax.devices()
    mesh = make_mesh(n_data=n_data, n_shard=n_shard, devices=devices)

    rng = np.random.default_rng(4242)
    nreads = B_TOTAL * (bmul if bmul else 1)
    bases = rng.integers(0, 4, size=(nreads, L)).astype(np.uint8)
    bases[:, READLEN:] = 4
    lengths = np.full((nreads,), READLEN, dtype=np.int32)

    case = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)
    mom = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)
    dad = ShardedSketch(mesh, KSIZE, SHARD_TABLESIZE * n_shard)

    result = {
        'devices': len(devices), 'n_data': n_data, 'n_shard': n_shard,
        'reads_per_rep': nreads, 'reps': REPS,
    }

    for route in routes:
        for sk in (case, mom, dad):       # warm up (compile)
            sk.consume_batch(bases, route=route)
        t0 = time.time()
        for _ in range(REPS):
            case.consume_batch(bases, route=route)
        np.asarray(case.tables.addressable_shards[0].data)
        wall = time.time() - t0
        result['consume_{}_s'.format(route)] = round(wall, 3)
        result['consume_{}_reads_per_s'.format(route)] = round(
            nreads * REPS / wall)

    if screen:
        res = sharded_novel_screen(mesh, [case], [mom, dad], bases, lengths,
                                   casemin=2, ctrlmax=255)
        np.asarray(res[0])                # warm up
        t0 = time.time()
        for _ in range(REPS):
            res = sharded_novel_screen(mesh, [case], [mom, dad], bases,
                                       lengths, casemin=2, ctrlmax=255)
            np.asarray(res[0])
        wall = time.time() - t0
        result['screen_s'] = round(wall, 3)
        result['screen_reads_per_s'] = round(nreads * REPS / wall)

    if not distributed or int(distributed[2]) == 0:
        with open(out, 'w') as fh:
            json.dump(result, fh)
    return result


def run_subprocess(ndev, n_data, n_shard, tag, tmpdir, bmul=None):
    out = os.path.join(tmpdir, 'scale_{}.json'.format(tag))
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    cmd = [sys.executable, os.path.abspath(__file__), '--worker',
           '--ndev', str(ndev), '--n-data', str(n_data),
           '--n-shard', str(n_shard), '--out', out]
    if bmul:
        cmd += ['--bmul', str(bmul)]
    subprocess.run(cmd, check=True, cwd=REPO, env=env,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(out) as fh:
        return json.load(fh)


def run_gloo(tmpdir, nproc, ndev_each):
    """nproc processes x ndev_each devices, shard axis spanning processes."""
    out = os.path.join(tmpdir, 'scale_gloo{}.json'.format(nproc))
    port = '29' + str(500 + (os.getpid() + nproc) % 100)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = []
    for pid in range(nproc):
        cmd = [sys.executable, os.path.abspath(__file__), '--worker',
               '--ndev', str(ndev_each), '--n-data', '1', '--n-shard', '8',
               '--distributed', 'localhost:' + port, str(nproc), str(pid),
               '--out', out]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
    for p in procs:
        if p.wait(timeout=1200) != 0:
            raise RuntimeError('gloo worker failed')
    with open(out) as fh:
        return json.load(fh)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--worker', action='store_true')
    ap.add_argument('--ndev', type=int, default=0)
    ap.add_argument('--n-data', type=int, default=1)
    ap.add_argument('--n-shard', type=int, default=1)
    ap.add_argument('--out', default='scaling_worker.json')
    ap.add_argument('--distributed', nargs=3, default=None,
                    metavar=('COORD', 'NPROC', 'PID'))
    ap.add_argument('--bmul', type=int, default=None,
                    help='batch multiplier override (equal-total-work runs)')
    args = ap.parse_args()
    if args.worker:
        res = worker(args.ndev, args.n_data, args.n_shard, args.out,
                     args.distributed, bmul=args.bmul)
        print(json.dumps(res))
        return

    import tempfile
    tmpdir = tempfile.mkdtemp(prefix='kevlar_scaling_')
    cores = os.cpu_count()
    results = {'host_physical_cores': cores,
               'reads_per_rep': B_TOTAL,
               'note': ('CPU-mesh proxy on {} physical cores at amortizing '
                        'batch sizes ({} reads/rep): virtual devices '
                        'SERIALIZE. The routed (all_to_all) consume does '
                        'constant total work, so its ideal serialized wall '
                        'is flat: routed_strong_efficiency = wall_1/wall_n. '
                        'The replicate fallback does n-fold redundant work '
                        'and keeps the legacy serialized_efficiency = '
                        'n*wall_1/wall_n. The data-axis row partitions the '
                        'SAME batch over 1 vs N devices (equal total work). '
                        'Gloo rows add the cross-process (DCN-analog) cost '
                        'at equal device count.').format(cores, B_TOTAL)}

    print('# shard-axis scaling, constant total batch', file=sys.stderr)
    shard_rows = []
    for n in (1, 2, 4, 8):
        row = run_subprocess(n, 1, n, 'shard{}'.format(n), tmpdir)
        shard_rows.append(row)
    base = shard_rows[0]
    for row in shard_rows:
        n = row['devices']
        row['routed_strong_efficiency'] = round(
            base['consume_alltoall_s'] / row['consume_alltoall_s'], 3)
        row['replicate_serialized_efficiency'] = round(
            n * base['consume_replicate_s'] / row['consume_replicate_s'], 3)
        row['alltoall_speedup'] = round(
            row['consume_replicate_s'] / row['consume_alltoall_s'], 3)
        row['screen_serialized_efficiency'] = round(
            n * base['screen_s'] / row['screen_s'], 3)
        print(json.dumps(row), flush=True)
    results['shard_axis'] = shard_rows

    print('# data-axis partitioning overhead at equal total work',
          file=sys.stderr)
    ndev = min(cores, 8)
    d1 = run_subprocess(1, 1, 1, 'data1', tmpdir)
    dn = run_subprocess(ndev, ndev, 1, 'data{}'.format(ndev), tmpdir)
    data = {'1_device': d1, 'N_devices_same_batch': dn,
            'consume_efficiency': round(
                d1['consume_alltoall_s'] / dn['consume_alltoall_s'], 3),
            'screen_efficiency': round(
                d1['screen_s'] / dn['screen_s'], 3)}
    results['data_axis'] = data
    print(json.dumps(data), flush=True)

    for nproc, ndev_each in ((2, 4), (4, 2)):
        print('# {}-process gloo (DCN analog), 8 devices total'.format(nproc),
              file=sys.stderr)
        try:
            gloo = run_gloo(tmpdir, nproc, ndev_each)
            single8 = shard_rows[-1]
            for key in ('consume_alltoall_s', 'consume_replicate_s',
                        'screen_s'):
                if key in gloo and key in single8:
                    gloo['vs_single_process_' + key.replace('_s', '')] = \
                        round(single8[key] / gloo[key], 3)
            results['gloo_{}proc'.format(nproc)] = gloo
            print(json.dumps(gloo), flush=True)
        except Exception as exc:  # gloo may be unavailable in some sandboxes
            results['gloo_{}proc'.format(nproc)] = {'error': str(exc)}
            print('# gloo run failed:', exc, file=sys.stderr)

    outpath = os.path.join(REPO, 'SCALING.json')
    with open(outpath, 'w') as fh:
        json.dump(results, fh, indent=1)
    print('# wrote', outpath, file=sys.stderr)


if __name__ == '__main__':
    main()
