"""Native (C++) runtime components: FASTX parsing, alignment, assembly.

Built on demand (``python -m kevlar_tpu.native.build`` or the module-level
:func:`build`) from the sources next to this file into
``libkevlar_native.so`` beside them.  Consumers fall back to the
pure-Python/numpy implementations when the library cannot be built or
loaded; :func:`load` then says why on stderr, once per process.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIBPATH = os.path.join(_HERE, 'libkevlar_native.so')
_SOURCES = ['fastx.cpp', 'align.cpp', 'asm.cpp']

_lib = None
_failure = None


class BuildError(RuntimeError):
    """The compiler refused the native sources; carries its message."""


def build(verbose=False):
    """Compile the native library. Returns the library path.

    Compiles to a temporary name and renames it into place, so processes
    building concurrently never load a partly written library.
    """
    tmp = '{}.{}.tmp'.format(_LIBPATH, os.getpid())
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
           '-o', tmp] + [os.path.join(_HERE, s) for s in _SOURCES] + \
          ['-lz']
    if verbose:
        print('[kevlar_tpu.native] ' + ' '.join(cmd), file=sys.stderr)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError('{} exited with {}:\n{}'.format(
            ' '.join(cmd), proc.returncode, proc.stderr.strip()))
    os.replace(tmp, _LIBPATH)
    return _LIBPATH


def _stale():
    if not os.path.exists(_LIBPATH):
        return True
    libtime = os.path.getmtime(_LIBPATH)
    return any(os.path.getmtime(os.path.join(_HERE, s)) > libtime
               for s in _SOURCES)


def load(auto_build=True):
    """Load (building if needed) the native library; None if unavailable.

    A failed build or load is reported on stderr with the compiler's or
    loader's message the first time, and not retried in this process.
    """
    global _lib, _failure
    if _lib is not None:
        return _lib
    if _failure is not None:
        return None
    try:
        if _stale() and auto_build:
            build()
        lib = ctypes.CDLL(_LIBPATH)
    except (OSError, BuildError) as exc:
        _failure = exc
        print('[kevlar_tpu.native] native library unavailable; the '
              'pure-Python parser, assembler and aligner run instead: '
              '{}: {}'.format(type(exc).__name__, exc), file=sys.stderr)
        return None
    lib.kt_fastx_open.restype = ctypes.c_void_p
    lib.kt_fastx_open.argtypes = [ctypes.c_char_p]
    lib.kt_fastx_next_batch.restype = ctypes.c_int
    lib.kt_fastx_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
    lib.kt_fastx_set_overlap.restype = None
    lib.kt_fastx_set_overlap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kt_fastx_close.argtypes = [ctypes.c_void_p]
    lib.kt_align.restype = ctypes.c_int
    lib.kt_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.kt_assemble.restype = ctypes.c_int
    lib.kt_assemble.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.kt_correct.restype = ctypes.c_int
    lib.kt_correct.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return _lib


def available():
    return load() is not None


# ---------------------------------------------------------------------------
# Python wrappers
# ---------------------------------------------------------------------------

class FastxBatchReader:
    """Stream [max_reads, max_len] padded base batches from a FASTX file."""

    def __init__(self, path, max_reads=4096, max_len=1024, want_quals=False,
                 overlap=0):
        lib = load()
        if lib is None:
            raise ImportError('native library unavailable')
        self._lib = lib
        self._handle = lib.kt_fastx_open(path.encode())
        if not self._handle:
            raise IOError('cannot open ' + path)
        if overlap:
            # records longer than max_len chunk into overlapping rows
            # (overlap = ksize-1 keeps every k-mer in exactly one row)
            lib.kt_fastx_set_overlap(self._handle, int(overlap))
        self.max_reads = max_reads
        self.max_len = max_len
        self.want_quals = want_quals

    def __iter__(self):
        return self

    def __next__(self):
        bases = np.full((self.max_reads, self.max_len), 4, dtype=np.uint8)
        lengths = np.zeros(self.max_reads, dtype=np.int32)
        names_cap = self.max_reads * 256
        names = ctypes.create_string_buffer(names_cap)
        quals = None
        qbuf = None
        if self.want_quals:
            qbuf = ctypes.create_string_buffer(self.max_reads * self.max_len)
        n = self._lib.kt_fastx_next_batch(
            self._handle, self.max_reads, self.max_len,
            bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            names, names_cap, qbuf)
        if n < 0:
            raise IOError('parse error in FASTX input')
        if n == 0:
            self.close()
            raise StopIteration
        # maxsplit: the zero-filled buffer tail would otherwise split into
        # ~names_cap empty strings (measured ~10ms per batch)
        namelist = names.raw.split(b'\0', n)[:n]
        if qbuf is not None:
            qarr = np.frombuffer(qbuf.raw, dtype=np.uint8).reshape(
                self.max_reads, self.max_len)
            quals = qarr[:n]
        return (bases[:n], lengths[:n],
                [s.decode('ascii', 'replace') for s in namelist], quals)

    def close(self):
        if self._handle:
            self._lib.kt_fastx_close(self._handle)
            self._handle = None


def align(target, query, match=1, mismatch=2, gapopen=5, gapextend=0):
    """(cigar, score) with exact ksw2 semantics, via the native aligner."""
    lib = load()
    if lib is None:
        raise ImportError('native library unavailable')
    cap = 2 * (len(target) + len(query)) + 64
    cigar = ctypes.create_string_buffer(cap)
    score = lib.kt_align(target.encode(), len(target), query.encode(),
                         len(query), match, mismatch, gapopen, gapextend,
                         cigar, cap)
    return cigar.value.decode(), score


def correct(seqs, k=25, minabund=2):
    """Spectral (k-mer spectrum) substitution-error correction: the BFC
    analog (fermi-lite bfc.c) — repairs weak k-mer runs anchored by solid
    ones.  Returns the corrected sequences (order preserved)."""
    lib = load()
    if lib is None:
        raise ImportError('native library unavailable')
    seqs = [s.sequence if hasattr(s, 'sequence') else s for s in seqs]
    arr = (ctypes.c_char_p * len(seqs))(*[s.encode() for s in seqs])
    cap = sum(len(s) for s in seqs) + len(seqs) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.kt_correct(arr, len(seqs), k, minabund, out, cap)
    return [p.decode() for p in out.raw.split(b'\0')[:n]]


def assemble(records, min_overlap=45):
    """Greedy overlap assembly of a partition; yields contig strings."""
    lib = load()
    if lib is None:
        raise ImportError('native library unavailable')
    seqs = [r.sequence if hasattr(r, 'sequence') else r for r in records]
    arr = (ctypes.c_char_p * len(seqs))(*[s.encode() for s in seqs])
    cap = sum(len(s) for s in seqs) + len(seqs) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.kt_assemble(arr, len(seqs), min_overlap, out, cap)
    pieces = out.raw.split(b'\0')[:n]
    for p in pieces:
        if p:
            yield p.decode()
