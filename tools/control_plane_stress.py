"""Human-scale stress for the host-side control-plane paths.

VERDICT r3 weak #6: partition union-find and localize clustering are
host-side; nobody had shown they stay out of the critical path at human
scale (~40x the 80 Mb bigsim run).  This tool synthesizes those workloads
at that scale and measures:

1. connected components on the read<->k-mer incidence list — host
   union-find vs the device label-propagation kernel (ops/cc_ops.py),
   at bigsim scale and 40x bigsim scale;
2. the full partition stage (ReadGraph.load + component extraction +
   per-partition dedup) on synthetic annotated reads at human-scale
   novel-read counts;
3. Localizer seed-position clustering (sort + gap-split per seqid) at
   millions of seed hits over 25 chromosomes.

Prints one JSON line; writes CONTROL_PLANE.json next to the repo root.

Usage: python tools/control_plane_stress.py [--scale 40]
       (host-only workloads; KEVLAR_PLATFORM=cpu is forced so the device
        label-prop kernel runs on the CPU backend — the same program as on
        an accelerator)
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault('KEVLAR_PLATFORM', 'cpu')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def synth_incidence(rng, n_parts, reads_per_part, kmers_per_part):
    """Bipartite (read, kmer) incidence of n_parts disjoint components."""
    reads, kmers = [], []
    rbase = kbase = 0
    for p in range(n_parts):
        nr = 1 + int(rng.integers(1, reads_per_part * 2))
        nk = 1 + int(rng.integers(1, kmers_per_part * 2))
        # each read carries a few of the partition's k-mers
        for r in range(nr):
            picks = rng.integers(0, nk, size=min(nk, 8))
            for k in np.unique(picks):
                reads.append(rbase + r)
                kmers.append(kbase + int(k))
        rbase += nr
        kbase += nk
    return (np.array(reads, np.int32), np.array(kmers, np.int32),
            rbase, kbase)


def bench_cc(scale):
    from kevlar_tpu.ops import cc_ops
    rng = np.random.default_rng(7)
    # bigsim r3: ~1.5k partitions; scale the partition count
    n_parts = int(1500 * scale)
    reads, kmers, n_reads, n_kmers = synth_incidence(rng, n_parts, 12, 20)
    rows = {'incidences': len(reads), 'reads': n_reads,
            'partitions': n_parts}

    t0 = time.time()
    host = cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers)
    rows['host_union_find_s'] = round(time.time() - t0, 2)

    t0 = time.time()
    dev = np.asarray(cc_ops.connected_components_bipartite_jit(
        reads, kmers, n_reads=n_reads, n_kmers=n_kmers))
    rows['device_label_prop_first_s'] = round(time.time() - t0, 2)
    t0 = time.time()
    dev = np.asarray(cc_ops.connected_components_bipartite_jit(
        reads, kmers, n_reads=n_reads, n_kmers=n_kmers))
    rows['device_label_prop_steady_s'] = round(time.time() - t0, 2)
    assert np.array_equal(host, dev), 'CC backends disagree'
    return rows


def bench_partition_stage(scale):
    """The full stage on synthetic annotated reads (novel-stage output
    shape): bigsim r3 had ~50k novel reads -> human ~40x."""
    import random as pyrandom
    from kevlar_tpu.readgraph import ReadGraph
    from kevlar_tpu.sequence import Record

    rng = pyrandom.Random(11)
    n_parts = int(400 * scale)
    readlen = 100
    records = []
    for p in range(n_parts):
        # one shared novel k-mer neighborhood per partition
        core = ''.join(rng.choice('ACGT') for _ in range(readlen + 40))
        nreads = rng.randint(4, 24)
        for r in range(nreads):
            off = rng.randint(0, 40)
            seq = core[off:off + readlen]
            rec = Record(name='p{}r{}'.format(p, r), sequence=seq,
                         quality='I' * readlen)
            for x in range(rng.randint(1, 6)):
                ko = rng.randint(0, readlen - 31)
                rec.annotate(seq[ko:ko + 31], ko, (9, 0, 0))
            records.append(rec)
    t0 = time.time()
    graph = ReadGraph()
    graph.load(iter(records))
    load_s = time.time() - t0
    t0 = time.time()
    nparts = sum(1 for _ in graph.partitions(dedup=True, minabund=2,
                                             maxabund=200))
    part_s = time.time() - t0
    return {'reads': len(records), 'partitions_found': nparts,
            'graph_load_s': round(load_s, 2),
            'partitions_s': round(part_s, 2)}


def bench_localize_cluster(scale):
    from kevlar_tpu.localize import Localizer
    rng = np.random.default_rng(3)
    n_hits = int(50_000 * scale)
    loc = Localizer(seedsize=51)
    seqids = ['chr{}'.format(i) for i in range(1, 26)]
    t0 = time.time()
    for s in seqids:
        for pos in rng.integers(0, 119_000_000, size=n_hits // 25):
            loc.add_seed_match(s, int(pos))
    add_s = time.time() - t0
    t0 = time.time()
    cutouts = sum(1 for _ in loc.get_cutouts(refrseqs=None, delta=50,
                                             clusterdist=1000))
    cluster_s = time.time() - t0
    return {'seed_hits': n_hits, 'add_s': round(add_s, 2),
            'cluster_s': round(cluster_s, 2), 'cutouts': cutouts}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--scale', type=float, default=40.0,
                    help='multiplier over the 80 Mb bigsim workload '
                         '(40 ~= human)')
    args = ap.parse_args()

    result = {'suite': 'control_plane_stress', 'scale_vs_bigsim': args.scale}
    result['cc_bigsim_scale'] = bench_cc(1.0)
    result['cc_human_scale'] = bench_cc(args.scale)
    result['partition_stage_human_scale'] = bench_partition_stage(args.scale)
    result['localize_cluster_human_scale'] = bench_localize_cluster(
        args.scale)
    out = os.path.join(REPO, 'CONTROL_PLANE.json')
    with open(out, 'w') as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    print('# wrote', out, file=sys.stderr)


if __name__ == '__main__':
    main()
