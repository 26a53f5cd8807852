"""kevlar_tpu: a reference-free trio variant-discovery framework on JAX.

A from-scratch re-design of the kevlar workflow (reference:
kevlar-dev/kevlar) for accelerators: k-mer counting and novel-k-mer
screening run as batched JAX kernels over device-resident Count-Min
sketches, read partitioning is device label-propagation, contig↔reference
alignment is a batched affine-gap DP with exact ksw2 semantics, and
likelihood scoring is vectorised.  Multi-device scaling shards the sketch
hash space across a ``jax.sharding.Mesh`` (the banding/scatter-gather
parallelism of the reference becomes collectives between devices).

Pipeline stages (each a module with a generator-style core + ``main(args)``):
count, novel, filter, unband, partition, split, assemble, localize, call,
alac, varfilter, simlike, plus utilities augment, dist, gentrio, mutate,
evaluate.
"""

import builtins
from gzip import open as gzopen
import os
from os import makedirs
from os.path import dirname
import re
import sys

__version__ = '0.1.0'

# Persistent XLA compilation cache: every CLI stage is its own process, and
# the cache makes each program's compile a one-time cost across a workflow.
# A JAX_COMPILATION_CACHE_DIR set by the caller is used as it is.  Otherwise
# the cache is the fixed directory .jax_cache at the checkout root: the path
# is part of each entry's key, so it must not depend on HOME, the working
# directory or the time.  A JAX imported before this package has already
# read its environment, so the default also goes through jax.config.
_cache_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
if not _cache_dir:
    _cache_dir = os.path.join(dirname(dirname(os.path.abspath(__file__))),
                              '.jax_cache')
    try:
        makedirs(_cache_dir, exist_ok=True)
    except OSError as _exc:
        print('kevlar_tpu: warning: cannot create the XLA compile cache {} '
              '({}); compiles will not be cached'.format(_cache_dir, _exc),
              file=sys.stderr)
        _cache_dir = None
    else:
        os.environ['JAX_COMPILATION_CACHE_DIR'] = _cache_dir
        os.environ.setdefault(
            'JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '1')
if _cache_dir and 'jax' in sys.modules:
    _jax = sys.modules['jax']
    if _jax.config.jax_compilation_cache_dir is None:
        _jax.config.update('jax_compilation_cache_dir', _cache_dir)
        _jax.config.update(
            'jax_persistent_cache_min_compile_time_secs',
            float(os.environ.get(
                'JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '1')))

# Optional platform override: KEVLAR_PLATFORM=cpu routes the (identical) XLA
# programs to the host backend, for small inputs or hosts without an
# accelerator.  A JAX imported before this package has already read
# JAX_PLATFORMS, so the override also goes through jax.config.
if os.environ.get('KEVLAR_PLATFORM'):
    _plat = os.environ['KEVLAR_PLATFORM']
    os.environ['JAX_PLATFORMS'] = _plat
    if 'jax' in sys.modules:
        sys.modules['jax'].config.update('jax_platforms', _plat)

logstream = None
teelog = False


def plog(*args, **kwargs):
    """Print logging output to the configured log stream."""
    if logstream is not None:
        print(*args, **kwargs, file=logstream)
    if logstream is None or teelog:
        print(*args, **kwargs, file=sys.stderr)


def device_banner():
    """One line naming the JAX version, platform, device kind and count.

    Every CLI stage and the workflow driver log it first, so a run that
    landed on another backend than intended shows in its log.
    """
    import jax
    devices = jax.devices()
    return 'JAX {} on {}: {} x{}'.format(
        jax.__version__, jax.default_backend(), devices[0].device_kind,
        len(devices))


def open(filename, mode):
    """gz-aware text open; '-'/None mean stdin/stdout."""
    if mode not in ('r', 'w'):
        raise ValueError('invalid mode "{}"'.format(mode))
    if filename in ('-', None):
        return sys.stdin if mode == 'r' else sys.stdout
    if str(filename).endswith('.gz'):
        return gzopen(filename, mode + 't')
    return builtins.open(filename, mode)


def mkdirp(path, trim=False):
    outdir = dirname(path) if trim else path
    makedirs(outdir, exist_ok=True)
    return outdir


def parse_bed(instream):
    """Yield (chrom, start, end, extra-fields) from BED text."""
    for line in instream:
        row = line.strip()
        if not row or row.startswith('#'):
            continue
        chrom, start, end, *extra = re.split(r'\s+', row)
        yield chrom, int(start), int(end), extra


def bedstream(bedfilelist):
    for bedfile in bedfilelist:
        yield from parse_bed(open(bedfile, 'r'))


# Core substrate
from kevlar_tpu.dna import revcom, revcommin, same_seq  # noqa: E402
from kevlar_tpu.support import (  # noqa: E402
    Timer, ProgressIndicator, MutableString,
)
from kevlar_tpu.sequence import (  # noqa: E402
    Record, KmerOfInterest, parse_augmented_fastx, print_augmented_fastx,
)
from kevlar_tpu import dna  # noqa: E402
from kevlar_tpu import seqio  # noqa: E402
from kevlar_tpu import batch  # noqa: E402
from kevlar_tpu import sketch  # noqa: E402
from kevlar_tpu.seqio import (  # noqa: E402
    parse_partitioned_reads, parse_single_partition,
)

# Pipeline stages (imported lazily via __getattr__ to keep startup light and
# avoid import cycles during incremental construction).
_STAGE_MODULES = (
    'count', 'novel', 'filter', 'unband', 'partition', 'split', 'assemble',
    'augment', 'localize', 'reference', 'call', 'varmap', 'cigar', 'alac',
    'varfilter', 'simlike', 'dist', 'gentrio', 'mutate', 'evaluate', 'vcf',
    'readgraph', 'readpair', 'intervalforest', 'support', 'cli',
    'ops', 'parallel', 'workflow', 'workflows', 'native', 'warm',
)


def __getattr__(name):
    if name in _STAGE_MODULES:
        import importlib
        module = importlib.import_module('kevlar_tpu.' + name)
        globals()[name] = module
        return module
    raise AttributeError('module kevlar_tpu has no attribute ' + name)


def multi_file_iter(filenames):
    from kevlar_tpu.seqio import multi_file_iter as mfi
    return mfi(filenames)


def vcf_header(outstream, version='4.2', source='kevlar', infoheader=False):
    print('##fileformat=VCFv', version, sep='', file=outstream)
    print('##source=', source, sep='', file=outstream)
    if infoheader:
        print('##INFO=<GT,Number=3,Type=String,Description="Genotypes of each '
              'individual in the trio (proband, mother, father)">',
              file=outstream)
    print('##INFO=<VW,Number=1,Type=String,Description="Genomic interval '
          'bounding all k-mers that contain the alternate allele">',
          file=outstream)
    print('##INFO=<RW,Number=1,Type=String,Description="Genomic interval '
          'bounding all k-mers that contain the reference allele">',
          file=outstream)
    print('#CHROM', 'POS', 'ID', 'REF', 'ALT', 'QUAL', 'FILTER', 'INFO',
          sep='\t', file=outstream)
