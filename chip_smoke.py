"""Smoke run of kevlar-tpu on an NVIDIA GPU through its normal entry points.

One process holds the card and runs, in order:

1. environment: JAX must come up on the GPU (JAX_PLATFORMS is pinned to
   cuda, so a machine without a working GPU fails instead of running on
   the CPU), and the native parser/assembler/aligner library must load;
2. main path: the reference quick-start analog
   (``tools/sim_trio_bench.py --preset helium``: 25 Mb genome, 30x trio,
   k=31, 500M sketches per sample) through
   ``kevlar_tpu.workflow.run_mark1``, which must find the 5 de novo
   variants with no false positive;
3. parity at the workflow's table sizes: device counts, the fused
   count+screen, the batched wavefront aligner, connected components and
   the device simlike scorer, each against a host reference; exact, except
   simlike at the tolerance of tests/test_simlike.py.  It also times the
   helium alac stage's alignments with both engines, the measurement
   behind ``align._DEVICE_BATCH_BY_PLATFORM``.

``--devices 4`` instead runs only the sharded path on a four-GPU
('data', 'shard') = (1, 4) mesh: ``count``/``novel``/``alac --shards 4``
against the same stages on one GPU.

Every line on standard output is one JSON object.  The last one,
``{"ok": true, "device": {...}}``, is printed only when every phase
passed; any failure raises, so the process exits non-zero without it.

Usage:
    python chip_smoke.py              # one GPU
    python chip_smoke.py --devices 4  # sharded path on four GPUs
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
KSIZE = 31
# the workflow's sketch sizes in tools/sim_trio_bench.py --preset helium
SAMPLE_MEMORY = 500e6
MASK_MEMORY = 50e6
PREFIX_READS = 1 << 19          # proband reads in the parity phases
ALIGN_PAIRS = 1024              # pairs per alignment bucket
SIMLIKE_BUNDLES = 1000
# CONTROL_PLANE.json's human-scale case (tools/control_plane_stress.py)
CC_PARTITIONS = 60000
# tests/test_simlike.py::test_device_scoring_matches_host
SIMLIKE_RTOL, SIMLIKE_ATOL = 2e-5, 2e-3


class SmokeFailure(Exception):
    """A phase's result disagreed with its reference."""


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def log(message):
    print(message, file=sys.stderr, flush=True)


def assert_equal_arrays(name, got, want):
    """Raise SmokeFailure naming the first and the number of differing
    elements unless ``got`` and ``want`` are equal in shape and value."""
    got = np.asarray(got)
    want = np.asarray(want)
    check(got.shape == want.shape, '{}: shape {} != reference {}'.format(
        name, got.shape, want.shape))
    diff = np.flatnonzero(got.ravel() != want.ravel())
    if diff.size:
        first = int(diff[0])
        raise SmokeFailure(
            '{}: {} of {} elements differ; first at flat index {}: {} != '
            'reference {}'.format(name, diff.size, want.size, first,
                                  got.ravel()[first], want.ravel()[first]))


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    EVENTS = ('/jax/core/compile/jaxpr_trace_duration',
              '/jax/core/compile/jaxpr_to_mlir_module_duration',
              '/jax/core/compile/backend_compile_duration')

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._record)

    def _record(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def timed(fn):
    """(result, seconds) of fn(), waiting for every device value."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# -- phase 1 ----------------------------------------------------------------

def phase_environment(n_devices):
    import jax
    t0 = time.perf_counter()
    devices = jax.devices()
    backend_init = time.perf_counter() - t0
    check(jax.default_backend() == 'gpu',
          'JAX backend is {!r}, not gpu'.format(jax.default_backend()))
    check(len(devices) >= n_devices, '{} GPU(s) present, {} needed'.format(
        len(devices), n_devices))
    import kevlar_tpu
    from kevlar_tpu import native
    check(os.path.dirname(os.path.abspath(kevlar_tpu.__file__))
          == os.path.join(HERE, 'kevlar_tpu'),
          'kevlar_tpu imported from {}, not from this checkout'.format(
              kevlar_tpu.__file__))
    check(native.available(), 'native library did not build or load')
    emit(phase='environment', jax=jax.__version__,
         platform=devices[0].platform, device_kind=devices[0].device_kind,
         count=len(devices), nvidia_smi=nvidia_smi(),
         backend_init_s=backend_init,
         compile_cache=os.environ.get('JAX_COMPILATION_CACHE_DIR'))
    return devices


# -- phase 2: main path -----------------------------------------------------

def phase_main_path(clock):
    import jax
    from sim_trio_bench import HELIUM, simulate, workflow_config, score_calls
    from kevlar_tpu.reference import autoindex
    from kevlar_tpu.workflow import run_mark1

    t0 = time.perf_counter()
    nreads = simulate(helium=True, log=log, **HELIUM)
    config = workflow_config(HELIUM['genome_size'], HELIUM['coverage'])
    autoindex('genome.fa', config['localize']['seed_size'])
    setup = time.perf_counter() - t0

    compile_before = clock.seconds
    t0 = time.perf_counter()
    finalvcf = run_mark1(config)
    wall = time.perf_counter() - t0
    compile_s = clock.seconds - compile_before
    found, total, npass, fps = score_calls(finalvcf)
    # the CPU backend keeps no memory statistics (None), the GPU does
    peak = (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')
    emit(phase='main_path', preset='helium', genome_size=HELIUM['genome_size'],
         coverage=HELIUM['coverage'], reads=nreads,
         sample_memory=config['case']['memory'],
         mask_memory=config['mask']['memory'], cuts='none',
         setup_s=setup, stage_wall_s=dict(run_mark1.last_stage_times),
         workflow_wall_s=wall, denovo_found=found, denovo_total=total,
         pass_calls=npass, false_positives=fps, peak_bytes_in_use=peak)
    emit(phase='main_path_startup', compile_s_inside_workflow_wall=compile_s,
         note='backend start-up is the environment phase backend_init_s; '
              'compiles fall inside the stage walls')
    check(total == 5 and found == 5 and fps == 0,
          'helium: {}/{} de novo calls, {} false positives'.format(
              found, total, fps))
    return config


# -- phase 3: parity --------------------------------------------------------

def read_prefix(path, nreads):
    """[N, L] base batches of the first ``nreads`` reads (whole batches)."""
    from kevlar_tpu.batch import DEFAULT_BATCH_SIZE, native_base_batches
    batches, lengths = [], []
    for bases, lens in native_base_batches(path, DEFAULT_BATCH_SIZE,
                                           overlap=KSIZE - 1):
        batches.append(bases)
        lengths.append(np.pad(lens, (0, bases.shape[0] - len(lens))))
        if len(batches) * DEFAULT_BATCH_SIZE >= nreads:
            break
    shapes = {b.shape for b in batches}
    check(len(shapes) == 1, 'read prefix has mixed batch shapes {}'.format(
        shapes))
    return np.stack(batches), np.stack(lengths)


def packed_stacks(bases, depth=8):
    """Device 2-bit stacks of ``depth`` batches, as count.py ships them."""
    import jax
    from kevlar_tpu.batch import pack_bases
    out = []
    for lo in range(0, len(bases), depth):
        packed, bad = pack_bases(bases[lo:lo + depth])
        out.append((jax.device_put(packed), jax.device_put(bad)))
    return out


def host_hashes(bases):
    from kevlar_tpu import dna
    return dna.kmer_hashes(bases.reshape(-1, bases.shape[-1]), KSIZE)


def device_count(stacks, L, bits, tablesize):
    """A device Sketch counted through the stacked consume count.py uses."""
    from kevlar_tpu.ops import sketch_ops
    from kevlar_tpu.sketch import Sketch
    sk = Sketch(KSIZE, tablesize, 4, counter_bits=bits)
    for packed, bad in stacks:
        sk.tables = sketch_ops.consume_batch_stack_packed(
            sk.tables, packed, bad, L=L, ksize=KSIZE, maxcount=sk.maxcount,
            counter_bits=bits, tablesize=tablesize)
    return sk


def parity_counts(bases):
    """Device Sketch counts vs Sketch(backend='host') at the workflow's
    three counter widths and table sizes."""
    from kevlar_tpu.sketch import allocate_from_memory
    h1, h2, valid = host_hashes(bases)
    nkmers = int(valid.sum())
    stacks = packed_stacks(bases)
    L = bases.shape[-1]
    for bits, memory, role in ((8, SAMPLE_MEMORY, 'sample .ct'),
                               (4, MASK_MEMORY, 'reference .sct'),
                               (1, MASK_MEMORY, 'mask .nt')):
        t0 = time.perf_counter()
        host = allocate_from_memory(KSIZE, memory, 4, bits, backend='host')
        tablesize = host.tablesize
        host.consume_hashes(h1, h2, valid)
        host_s = time.perf_counter() - t0
        first, first_s = timed(lambda: device_count(
            stacks, L, bits, tablesize).tables)
        del first
        t0 = time.perf_counter()
        sk = device_count(stacks, L, bits, tablesize)
        sk.tables.block_until_ready()
        steady_s = time.perf_counter() - t0
        assert_equal_arrays('{}-bit counts'.format(bits), sk._host(),
                            host.tables)
        del sk, host
        emit(phase='parity_counts', role=role, counter_bits=bits,
             memory=memory, tablesize=tablesize, ntables=4,
             reads=int(bases.shape[0] * bases.shape[1]), kmers=nkmers,
             batch_reads=int(bases.shape[1]), stack_depth=8,
             first_s=first_s, steady_s=steady_s,
             steady_kmers_per_s=nkmers / steady_s, host_s=host_s,
             equal=True)


def host_min_counts(h1, h2, valid, tablesize, query_h1, query_h2):
    """Plain numpy recount: min-over-4-tables saturated counts of the
    query hashes in a sketch of every valid (h1, h2)."""
    out = None
    for t in range(4):
        idx = (h1 + np.uint32(t) * h2) % np.uint32(tablesize)
        hist = np.bincount(idx[valid].astype(np.int64), minlength=tablesize)
        q = (query_h1 + np.uint32(t) * query_h2) % np.uint32(tablesize)
        c = np.minimum(hist[q.astype(np.int64)], 255).astype(np.uint8)
        out = c if out is None else np.minimum(out, c)
    return out


def parity_fused_screen(samples, casemin=5, ctrlmax=1, max_hits=32768):
    """count_and_screen_stack_packed hits vs a numpy host recount."""
    import jax.numpy as jnp
    from kevlar_tpu.batch import pack_bases
    from kevlar_tpu.ops import novel_ops
    from kevlar_tpu.sketch import allocate_from_memory
    tablesize = allocate_from_memory(KSIZE, SAMPLE_MEMORY, 4, 8,
                                     backend='host').tablesize
    case, case_len = samples[0]
    NB, B, L = case.shape
    P = L - KSIZE + 1
    hashes = [host_hashes(bases) for bases, _ in samples]
    h1, h2, valid = hashes[0]
    counts = [host_min_counts(sh1, sh2, sv, tablesize, h1, h2)
              for sh1, sh2, sv in hashes]
    skip = (case_len < KSIZE).reshape(-1)
    want = (valid & (counts[0] >= casemin) & ~skip[:, None]
            & (counts[1] <= ctrlmax) & (counts[2] <= ctrlmax))
    want = want.reshape(NB, B * P)
    packs = [pack_bases(bases) for bases, _ in samples]
    (outs, _, _), secs = timed(
        lambda: novel_ops.count_and_screen_stack_packed(
            jnp.asarray(packs[0][0]), jnp.asarray(packs[0][1]),
            tuple(jnp.asarray(p) for p, _ in packs[1:]),
            tuple(jnp.asarray(b) for _, b in packs[1:]),
            jnp.asarray(case_len), L=L, ksize=KSIZE, tablesize=tablesize,
            ntables=4, maxcount=255, casemin=casemin, ctrlmax=ctrlmax,
            max_hits=max_hits))
    hit_idx, hit_abunds, n_hits, _, dev_skip = (np.asarray(x) for x in outs)
    check(int(n_hits.max()) <= max_hits,
          'fused screen overflowed max_hits: {}'.format(n_hits.max()))
    assert_equal_arrays('fused skip', dev_skip, skip.reshape(NB, B))
    assert_equal_arrays('fused hits per batch', n_hits, want.sum(1))
    for b in range(NB):
        n = int(n_hits[b])
        idx = np.flatnonzero(want[b])
        assert_equal_arrays('fused hit positions, batch {}'.format(b),
                            hit_idx[b, :n], idx)
        rows = np.stack([c.reshape(NB, B * P)[b, idx] for c in counts])
        assert_equal_arrays('fused hit abundances, batch {}'.format(b),
                            hit_abunds[b, :, :n], rows)
    emit(phase='parity_fused_screen', tablesize=tablesize,
         reads_per_sample=NB * B, casemin=casemin, ctrlmax=ctrlmax,
         hits=int(n_hits.sum()), seconds_with_compile=secs, equal=True)


def random_pairs(rng, n, lo, hi):
    """Targets of length lo..hi and queries that differ from them by a
    few substitutions and short indels, both within the same bucket."""
    acgt = np.array(list('ACGT'))
    pairs = []
    for _ in range(n):
        target = ''.join(acgt[rng.integers(0, 4, int(rng.integers(lo, hi)))])
        query = list(target)
        for _ in range(int(rng.integers(0, 6))):
            pos = int(rng.integers(0, len(query)))
            kind = rng.integers(0, 3)
            if kind == 0:
                query[pos] = acgt[rng.integers(0, 4)]
            elif kind == 1:
                query.insert(pos, ''.join(acgt[rng.integers(0, 4, 3)]))
            else:
                del query[pos:pos + 3]
        pairs.append((target, ''.join(query)))
    return pairs


def parity_alignment(seed=7):
    """align_ops.align_batch vs the native aligner at the 256 and 512
    buckets alac uses: exact (cigar, score)."""
    from kevlar_tpu import native
    from kevlar_tpu.ops import align_ops
    rng = np.random.default_rng(seed)
    for bucket, lo in ((256, 200), (512, 440)):
        pairs = random_pairs(rng, ALIGN_PAIRS, lo, bucket - 16)
        check(max(len(q) for _, q in pairs) <= bucket, 'query past bucket')
        targets = [t for t, _ in pairs]
        queries = [q for _, q in pairs]
        t0 = time.perf_counter()
        want = [native.align(t, q) for t, q in pairs]
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        align_ops.align_batch(targets, queries)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = align_ops.align_batch(targets, queries)
        steady_s = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise SmokeFailure(
                '{}-bucket alignment: {} of {} pairs differ; pair {}: {} != '
                'native {}'.format(bucket, len(bad), len(pairs), bad[0],
                                   got[bad[0]], want[bad[0]]))
        emit(phase='parity_alignment', bucket=bucket, pairs=len(pairs),
             native_s=native_s, device_first_s=first_s,
             device_steady_s=steady_s,
             native_pairs_per_s=len(pairs) / native_s,
             device_steady_pairs_per_s=len(pairs) / steady_s, equal=True)


def alac_engine_timing(config):
    """Time the helium alac stage's alignments with each engine on the
    workflow's own partitioned reads: native, device, device, native."""
    from kevlar_tpu import alac as alac_mod, call as call_mod, seqio
    import kevlar_tpu
    loc = config['localize']
    reader = kevlar_tpu.parse_augmented_fastx(
        kevlar_tpu.open(os.path.join(config['outdir'],
                                     'partitioned.augfastq.gz'), 'r'))
    contigs = alac_mod._assembled_contigs(
        seqio.parse_partitioned_reads(reader), 10000, config['threads'],
        None)
    targets = alac_mod._localized_targets(
        contigs, config['reference']['fasta'], seedsize=loc['seed_size'],
        delta=loc['delta'], maxdiff=None, inclpattern=None,
        exclpattern=None)
    jobs = {pid: call_mod.partition_jobs(targets[pid], contigs[pid],
                                         10000)[3] for pid in targets}
    npairs = sum(len(j) for j in jobs.values())
    results, walls = {}, []
    saved = os.environ.get('KEVLAR_ALIGN_BACKEND')
    try:
        for engine in ('native', 'device', 'device', 'native'):
            os.environ['KEVLAR_ALIGN_BACKEND'] = engine
            out, secs = timed(lambda: call_mod.align_partitions(jobs))
            walls.append((engine, secs))
            results.setdefault(engine, out)
    finally:
        if saved is None:
            os.environ.pop('KEVLAR_ALIGN_BACKEND', None)
        else:
            os.environ['KEVLAR_ALIGN_BACKEND'] = saved
    check(results['native'] == results['device'],
          'alac alignments differ between the native and device engines')
    emit(phase='alac_engine_timing', partitions=len(jobs), pairs=npairs,
         walls_s=walls, equal=True)


def parity_components(seed=7):
    """cc_ops label propagation vs the host union-find at the human-scale
    partition count of tools/control_plane_stress.py --scale 40."""
    from control_plane_stress import synth_incidence
    from kevlar_tpu.ops import cc_ops
    rng = np.random.default_rng(seed)
    reads, kmers, n_reads, n_kmers = synth_incidence(rng, CC_PARTITIONS, 12,
                                                     20)
    t0 = time.perf_counter()
    host = cc_ops.host_connected_components(reads, kmers, n_reads, n_kmers)
    host_s = time.perf_counter() - t0
    _, first_s = timed(lambda: cc_ops.connected_components_bipartite_jit(
        reads, kmers, n_reads=n_reads, n_kmers=n_kmers))
    dev, steady_s = timed(lambda: cc_ops.connected_components_bipartite_jit(
        reads, kmers, n_reads=n_reads, n_kmers=n_kmers))
    assert_equal_arrays('component labels', dev, host)
    emit(phase='parity_components', incidences=len(reads), reads=n_reads,
         kmers=n_kmers, components=int(len(np.unique(host))),
         host_s=host_s, device_first_s=first_s, device_steady_s=steady_s,
         equal=True)


def parity_simlike(seed=77):
    """Device simlike scoring vs the float64 host likelihoods."""
    import random
    from kevlar_tpu.ops import simlike_ops
    from kevlar_tpu.simlike import (_AbundanceBundle, likelihood_denovo,
                                    likelihood_false, likelihood_inherited)
    rng = random.Random(seed)
    bundles, want = [], []
    for _ in range(SIMLIKE_BUNDLES):
        K = rng.randint(0, 40)
        case = np.array([rng.randint(0, 40) for _ in range(K)])
        mom = np.array([rng.randint(0, 6) for _ in range(K)])
        dad = np.array([rng.randint(0, 6) for _ in range(K)])
        refr = ([rng.randint(0, 4) for _ in range(K)] if rng.random() < 0.5
                else [None] * K)
        bundle = _AbundanceBundle(case, [mom, dad], refr, 0)
        abunds = bundle.aslists()
        bundles.append(bundle)
        want.append((
            likelihood_denovo(abunds, refr, mean=25.0, sd=7.0, error=0.001),
            likelihood_false(abunds, refr, mean=25.0, error=0.001),
            likelihood_inherited(abunds, mean=25.0, sd=7.0, error=0.001)))
    got = np.array(simlike_ops.score_bundles(bundles, mean=25.0, sd=7.0,
                                             error=0.001)).T
    want = np.array(want)
    err = np.abs(got - want)
    ok = err <= SIMLIKE_ATOL + SIMLIKE_RTOL * np.abs(want)
    check(ok.all(), 'simlike: {} of {} likelihoods outside rtol {} atol {}; '
          'worst abs error {}'.format(int((~ok).sum()), ok.size,
                                      SIMLIKE_RTOL, SIMLIKE_ATOL,
                                      float(err.max())))
    emit(phase='parity_simlike', bundles=len(bundles), rtol=SIMLIKE_RTOL,
         atol=SIMLIKE_ATOL, max_abs_error=float(err.max()),
         max_rel_error=float((err / np.maximum(np.abs(want), 1e-12)).max()),
         within_tolerance=True)


def phase_parity(config):
    prefix = {who: read_prefix(who + '.fq', PREFIX_READS)
              for who in ('proband', 'mother', 'father')}
    parity_counts(prefix['proband'][0])
    parity_fused_screen([prefix[w] for w in ('proband', 'mother', 'father')])
    del prefix
    parity_alignment()
    alac_engine_timing(config)
    parity_components()
    parity_simlike()


# -- --devices 4: the sharded path ------------------------------------------

def phase_sharded(n_devices):
    """count/novel/alac --shards N on an N-GPU mesh vs the same stages on
    one GPU; the mesh must span N distinct cards."""
    import jax
    from sim_trio_bench import DEFAULTS, simulate
    from kevlar_tpu import cli
    from kevlar_tpu.parallel import ShardedSketch, make_mesh
    from kevlar_tpu.sketch import load

    mesh = make_mesh(n_shard=n_devices)
    check(dict(mesh.shape) == {'data': 1, 'shard': n_devices},
          'mesh shape {}'.format(dict(mesh.shape)))
    probe = ShardedSketch(mesh, KSIZE, 1 << 20)
    spans = {d.id for d in probe.tables.sharding.device_set}
    check(len(spans) == n_devices,
          'sharded tables live on devices {}'.format(sorted(spans)))
    shard_devices = sorted(s.device.id for s in
                           probe.tables.addressable_shards)
    check(len(set(shard_devices)) == n_devices,
          'shards on devices {}'.format(shard_devices))
    del probe

    simulate(log=log, **DEFAULTS)
    shards = ['--shards', str(n_devices)]

    def run(arglist):
        t0 = time.perf_counter()
        cli.main(arglist)
        return time.perf_counter() - t0

    walls = {}
    for who in ('proband', 'mother', 'father'):
        for tag, extra in (('one', []), ('sharded', shards)):
            walls['count {} {}'.format(who, tag)] = run(
                ['count', '-k', str(KSIZE), '-M', '100M'] + extra +
                ['{}.{}.ct'.format(who, tag), who + '.fq'])
        one = load('{}.one.ct'.format(who), backend='host', cache=False)
        many = load('{}.sharded.ct'.format(who), backend='host', cache=False)
        assert_equal_arrays('count --shards {} {}'.format(n_devices, who),
                            many.tables, one.tables)
    novel = ['novel', '-k', str(KSIZE), '--case-min', '5', '--ctrl-max', '1',
             '--case', 'proband.fq', '--case-counts', 'proband.one.ct',
             '--control-counts', 'mother.one.ct', 'father.one.ct']
    walls['novel one'] = run(novel + ['--out', 'novel.one.augfastq'])
    walls['novel sharded'] = run(novel + shards +
                                 ['--out', 'novel.sharded.augfastq'])
    one_text = open('novel.one.augfastq').read()
    check(one_text.strip(), 'novel found nothing')
    check(open('novel.sharded.augfastq').read() == one_text,
          'novel --shards output differs from one GPU')
    run(['filter', 'novel.one.augfastq', '-o', 'filtered.augfastq'])
    run(['partition', 'filtered.augfastq', '-o', 'partitioned.augfastq'])
    alac = ['alac', '-k', str(KSIZE), 'partitioned.augfastq', 'genome.fa']
    walls['alac one'] = run(alac + ['-o', 'calls.one.vcf'])
    walls['alac sharded'] = run(alac + shards + ['-o', 'calls.sharded.vcf'])

    def rows(path):
        with open(path) as fh:
            return [line for line in fh if not line.startswith('#')]
    one_rows = rows('calls.one.vcf')
    check(one_rows, 'alac called nothing')
    check(rows('calls.sharded.vcf') == one_rows,
          'alac --shards VCF rows differ from one GPU')
    emit(phase='sharded', devices=n_devices, mesh=dict(mesh.shape),
         mesh_device_ids=shard_devices, calls=len(one_rows),
         novel_bytes=len(one_text), walls_s=walls, equal=True)
    return jax.devices()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--devices', type=int, choices=(1, 4), default=1,
                    help='1: environment, main path and parity on one GPU; '
                         '4: only the sharded path on four GPUs')
    args = ap.parse_args(argv)

    platforms = os.environ.get('JAX_PLATFORMS', '')
    if platforms and not {'cuda', 'gpu'} & set(platforms.split(',')):
        raise SmokeFailure('chip_smoke.py runs on the GPU; JAX_PLATFORMS={} '
                           'asks for another platform'.format(platforms))
    os.environ['JAX_PLATFORMS'] = 'cuda'
    os.environ.pop('KEVLAR_PLATFORM', None)
    sys.path.insert(0, os.path.join(HERE, 'tools'))

    devices = phase_environment(args.devices)
    clock = CompileClock()
    workdir = tempfile.mkdtemp(prefix='kevlar_smoke_')
    cwd = os.getcwd()
    try:
        os.chdir(workdir)
        if args.devices == 1:
            config = phase_main_path(clock)
            phase_parity(config)
        else:
            devices = phase_sharded(args.devices)
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    emit(ok=True, device={'platform': devices[0].platform,
                          'kind': devices[0].device_kind,
                          'count': len(devices)})


if __name__ == '__main__':
    main()
