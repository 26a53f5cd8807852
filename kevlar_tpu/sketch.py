"""Count-Min sketch engine: the device replacement for khmer's tables.

Implements the khmer API surface the reference actually uses (SURVEY.md §2.1
"khmer API surface"; /root/reference/kevlar/sketch.py): allocate/load/save/
autoload with extension-typed counter widths, ``get``/``get_kmer_counts``/
``get_kmers``/``hash``/``add``/``consume``, ``ksize()``/``hashsizes()``/
``n_occupied()``/``n_unique_kmers()``, FPR estimation and the
``KevlarUnsuitableFPRError`` bailout.

Architecture: the counters live on device as a ``uint8 [ntables, tablesize]``
array updated by jitted scatter kernels (:mod:`kevlar_tpu.ops.sketch_ops`).
A lazily-synced numpy mirror serves host-side point lookups.  The on-disk
format is ``.npz`` (tables + metadata); the khmer-style filename extensions
(.ct/.sct/.nt/...) select the counter width exactly as in the reference, but
the binary layout is our own.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kevlar_tpu import dna
from kevlar_tpu.ops import sketch_ops


class KevlarSketchTypeError(ValueError):
    pass


class KevlarUnsuitableFPRError(SystemExit):
    pass


# counter width (bits) by khmer-compatible filename extension
COUNTER_BITS_BY_EXTENSION = {
    '.nt': 1, '.nodetable': 1,
    '.ng': 1, '.nodegraph': 1,
    '.ct': 8, '.counttable': 8,
    '.cg': 8, '.countgraph': 8,
    '.sct': 4, '.smallcounttable': 4,
    '.scg': 4, '.smallcountgraph': 4,
}

# buckets of counter storage per byte of memory budget (khmer parity:
# count.py:29-34 tablesize = memory/4 * buckets_per_byte)
BUCKETS_PER_BYTE = {1: 8, 4: 2, 8: 1}
MAXCOUNT = {1: 1, 4: 15, 8: 255}

def _np_pack(tables, bits):
    """[T, Z] uint8 counter values -> bit-packed rows (LSB-first, matching
    sketch_ops.pack_counter_row)."""
    if bits == 8:
        return tables
    if bits == 1:
        return np.packbits(tables.astype(bool), axis=1, bitorder='little')
    Z = tables.shape[1]
    pad = (-Z) % 2
    t = np.pad(tables, ((0, 0), (0, pad)))
    return (t[:, 0::2] | (t[:, 1::2] << 4)).astype(np.uint8)


def _np_unpack(packed, bits, Z):
    """bit-packed rows -> [T, Z] uint8 counter values."""
    if bits == 8:
        return packed
    if bits == 1:
        return np.unpackbits(packed, axis=1, bitorder='little')[:, :Z]
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.uint8)
    out[:, 0::2] = packed & 0xF
    out[:, 1::2] = packed >> 4
    return out[:, :Z]


# (count?, graph?, smallcount?) -> extensions, mirroring the reference's
# sketch_extensions_by_trait registry (sketch.py:30-51)
def get_extension(count=False, graph=False, smallcount=False):
    if count:
        if graph:
            return ('.scg', '.smallcountgraph') if smallcount \
                else ('.cg', '.countgraph')
        return ('.sct', '.smallcounttable') if smallcount \
            else ('.ct', '.counttable')
    return ('.ng', '.nodegraph') if graph else ('.nt', '.nodetable')


class Sketch:
    """Count-Min sketch with canonical k-mer hashing.

    ``backend='device'`` (default) keeps the counters on the accelerator and
    updates them with jitted scatter kernels — the bulk-counting path.
    ``backend='host'`` keeps them in numpy — for small control-plane sketches
    (filter re-counts, call-mask generation) where device dispatch/compile
    latency would dominate the work.
    """

    def __init__(self, ksize, tablesize, ntables=4, counter_bits=8,
                 tables=None, backend='device'):
        tablesize = int(tablesize)
        if tablesize < 1:
            raise ValueError('tablesize must be positive')
        self._ksize = int(ksize)
        self.tablesize = tablesize
        self.ntables = int(ntables)
        self.counter_bits = int(counter_bits)
        self.maxcount = MAXCOUNT[self.counter_bits]
        self.backend = backend
        self._n_occupied = None
        if backend == 'host':
            if tables is None:
                self.tables = np.zeros((self.ntables, tablesize),
                                       dtype=np.uint8)
            else:
                self.tables = np.asarray(tables, dtype=np.uint8)
            self._host_tables = self.tables
        else:
            # sub-byte counters stay bit-packed in device memory (khmer
            # memory parity: 1-bit Nodetables 8 buckets/byte, 4-bit
            # SmallCounttables 2/byte); `tables` inputs arrive unpacked
            width = sketch_ops.packed_width(tablesize, self.counter_bits)
            if tables is None:
                self.tables = jnp.zeros((self.ntables, width),
                                        dtype=jnp.uint8)
            else:
                self.tables = jnp.asarray(_np_pack(
                    np.asarray(tables, dtype=np.uint8), self.counter_bits))
            self._host_tables = None

    # -- khmer-parity introspection ------------------------------------
    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return [self.tablesize] * self.ntables

    def n_occupied(self):
        # Sketches loaded from file carry their occupancy as metadata, so
        # loading never touches (or transfers) the tables.  Freshly counted
        # device sketches use a 4-byte device reduction (persistently
        # cached compile) instead of pulling the full mirror; if the mirror
        # is already synced (host backend, or post-save), count it there.
        if self._n_occupied is None:
            if self.backend == 'device' and self._host_tables is None:
                from kevlar_tpu.ops import sketch_ops
                self._n_occupied = int(sketch_ops.occupancy_packed(
                    self.tables, self.counter_bits, self.tablesize))
            else:
                self._n_occupied = int(np.count_nonzero(self._host()[0]))
        return self._n_occupied

    def n_unique_kmers(self):
        """Estimated distinct k-mers via Bloom occupancy inversion.

        khmer tracks this exactly during consume; an estimate is sufficient
        here (it only feeds log output and FPR-style diagnostics).
        """
        occ = self.n_occupied()
        if occ >= self.tablesize:
            return self.tablesize
        frac = occ / self.tablesize
        return int(round(-self.tablesize * np.log1p(-frac)))

    # -- host mirror (always unpacked counter values) ---------------------
    def _host(self):
        if self._host_tables is None:
            self._host_tables = _np_unpack(
                np.asarray(self.tables), self.counter_bits, self.tablesize)
        return self._host_tables

    def _invalidate(self):
        if self.backend != 'host':
            self._host_tables = None
        self._n_occupied = None

    # -- host-backend counting -------------------------------------------
    def _host_consume_hashes(self, h1, h2, valid=None):
        h1 = np.asarray(h1, dtype=np.uint32)
        h2 = np.asarray(h2, dtype=np.uint32)
        if valid is not None:
            keep = np.asarray(valid, dtype=bool).ravel()
            h1 = h1.ravel()[keep]
            h2 = h2.ravel()[keep]
        else:
            h1 = h1.ravel()
            h2 = h2.ravel()
        for t in range(self.ntables):
            idx = ((h1 + np.uint32(t) * h2) % np.uint32(self.tablesize))
            # touch only the hit buckets: a full-table bincount (plus the
            # int64 widening of the whole table) made every chunk O(table)
            uniq, cnt = np.unique(idx.astype(np.int64), return_counts=True)
            cur = self.tables[t][uniq].astype(np.int64)
            self.tables[t][uniq] = np.minimum(
                cur + cnt, self.maxcount).astype(np.uint8)
        self._host_tables = self.tables
        return len(h1)

    # -- hashing helpers ------------------------------------------------
    def hash(self, kmer):
        """64-bit canonical hash of a k-mer string (h1<<32 | h2)."""
        h1, h2 = dna.hash_kmer(kmer)
        return (h1 << 32) | h2

    def reverse_hash(self, value):
        """Table hashes are one-way (khmer raises the same error for its
        table types; only graph types hash reversibly)."""
        raise ValueError('reverse hashing not implemented for table-hashed '
                         'sketches')

    def get_kmers(self, seq):
        k = self._ksize
        return [seq[i:i + k] for i in range(len(seq) - k + 1)]

    # -- point/host queries ----------------------------------------------
    def _host_counts(self, h1, h2, valid=None):
        tables = self._host()
        counts = None
        for t in range(self.ntables):
            idx = (h1 + np.uint32(t) * h2) % np.uint32(self.tablesize)
            c = tables[t][idx.astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        if valid is not None:
            counts = np.where(valid, counts, 0)
        return counts

    def get(self, kmer):
        """Count of a single k-mer (canonical)."""
        h1, h2 = dna.hash_kmer(kmer)
        return int(self._host_counts(np.uint32([h1]), np.uint32([h2]))[0])

    def get_kmer_counts(self, seq):
        """Counts for every k-mer of `seq` (invalid windows -> 0)."""
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        return [int(c) for c in self._host_counts(h1, h2, valid)]

    def get_kmer_hashes(self, seq):
        """64-bit canonical hashes for the valid k-mers of `seq`.

        khmer-contract API (reference usage: SURVEY §2.1); hash values use
        this package's scheme, with the same canonicality invariant.
        """
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        keys = (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)
        return [int(key) for key, v in zip(keys, valid) if v]

    def abundance_distribution(self, records, tracking):
        """Histogram of distinct-k-mer abundances, khmer-style.

        ``records`` is an iterable of Records (or a filename); ``tracking``
        is a presence sketch (counter_bits=1) used to count each distinct
        k-mer exactly once across calls.  Returns a length-256 array where
        entry ``c`` is the number of distinct k-mers with count ``c``
        (reference contract: khmer ``abundance_distribution(parser,
        tracking)`` used by dist.py:53).
        """
        from kevlar_tpu import seqio
        from kevlar_tpu.batch import batches_from_records
        if isinstance(records, str):
            records = seqio.multi_file_iter([records])
        hist = np.zeros(256, dtype=np.int64)
        for batch in batches_from_records(records):
            h1, h2, valid = dna.kmer_hashes(batch.bases, self._ksize)
            h1, h2, valid = h1.ravel(), h2.ravel(), valid.ravel()
            fresh = valid & (tracking._host_counts(h1, h2, valid) == 0)
            if not fresh.any():
                continue
            keys = (h1.astype(np.uint64) << np.uint64(32)) | \
                h2.astype(np.uint64)
            _, first = np.unique(keys[fresh], return_index=True)
            idx = np.flatnonzero(fresh)[first]
            counts = self._host_counts(h1[idx], h2[idx])
            np.add.at(hist, np.clip(counts, 0, 255).astype(np.int64), 1)
            tracking._host_consume_hashes(h1[idx], h2[idx])
        return hist

    # -- mutation ---------------------------------------------------------
    def add(self, kmer):
        self.consume(kmer)

    def count(self, kmer):
        self.consume(kmer)

    def consume(self, seq):
        """Count every k-mer in a sequence string. Returns #k-mers consumed.

        The sequence is padded to a bucketed length so repeated calls with
        varying lengths (e.g. mask windows) share one compiled kernel.
        """
        if len(seq) < self._ksize:
            return 0
        from kevlar_tpu.batch import bucket_length
        pad = bucket_length(len(seq))
        bases = np.full((1, pad), 4, dtype=np.uint8)
        bases[0, :len(seq)] = dna.encode(seq)
        return int(self.consume_batch(jnp.asarray(bases)))

    def consume_batch(self, bases, numbands=None, band=None, mask=None,
                      mask_threshold=0, consume_masked=False):
        """Count all k-mers of a padded [B, L] base-code batch on device.

        Returns the number of k-mers consumed as a *device* scalar — call
        ``int()`` on it only when needed, so streaming consume loops don't
        force a host sync per batch.
        """
        if self.backend == 'host':
            h1, h2, valid = dna.kmer_hashes(np.asarray(bases), self._ksize)
            if numbands:
                valid = valid & ((h1 & np.uint32(numbands - 1))
                                 == np.uint32(band))
            if mask is not None:
                mcnt = mask._host_counts(h1, h2)
                if consume_masked:
                    valid = valid & (mcnt >= mask_threshold)
                else:
                    valid = valid & (mcnt <= mask_threshold)
            return self._host_consume_hashes(h1, h2, valid)
        mask_tables = _device_mask_tables(mask)
        self.tables, n = sketch_ops.consume_batch(
            self.tables, jnp.asarray(bases), ksize=self._ksize,
            maxcount=self.maxcount, numbands=numbands, band=band,
            mask_tables=mask_tables, has_mask=mask is not None,
            mask_threshold=mask_threshold, consume_masked=consume_masked,
            counter_bits=self.counter_bits, tablesize=self.tablesize,
            mask_bits=mask.counter_bits if mask is not None else 8,
            mask_tablesize=mask.tablesize if mask is not None else None)
        self._invalidate()
        return n

    def consume_batch_stack(self, bases_stack, numbands=None, band=None,
                            mask=None, mask_threshold=0,
                            consume_masked=False):
        """Count a [NB, B, L] stack of batches in one device dispatch."""
        if self.backend == 'host':
            for bases in bases_stack:
                self.consume_batch(bases, numbands=numbands, band=band,
                                   mask=mask, mask_threshold=mask_threshold,
                                   consume_masked=consume_masked)
            return
        mask_tables = _device_mask_tables(mask)
        self.tables = sketch_ops.consume_batch_stack(
            self.tables, jnp.asarray(bases_stack), ksize=self._ksize,
            maxcount=self.maxcount, numbands=numbands, band=band,
            mask_tables=mask_tables, has_mask=mask is not None,
            mask_threshold=mask_threshold, consume_masked=consume_masked,
            counter_bits=self.counter_bits, tablesize=self.tablesize,
            mask_bits=mask.counter_bits if mask is not None else 8,
            mask_tablesize=mask.tablesize if mask is not None else None)
        self._invalidate()

    def consume_hashes(self, h1, h2, valid=None):
        """Count pre-hashed k-mers (uint32 arrays)."""
        if self.backend == 'host':
            return self._host_consume_hashes(h1, h2, valid)
        if valid is None:
            valid = jnp.ones(h1.shape, dtype=bool)
        self.tables, n = sketch_ops.consume_hash_batch(
            self.tables, jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(valid),
            maxcount=self.maxcount, counter_bits=self.counter_bits,
            tablesize=self.tablesize)
        self._invalidate()
        return int(n)

    def query_batch(self, bases):
        """Device query: counts [B, P] uint8 + validity for a base batch."""
        return sketch_ops.query_batch(self.tables, jnp.asarray(bases),
                                      self._ksize,
                                      counter_bits=self.counter_bits,
                                      tablesize=self.tablesize)

    # -- persistence ------------------------------------------------------
    def save(self, filename):
        # Uncompressed by default: sketch files are load-latency-critical
        # (every downstream stage's wall clock includes loading them) and
        # zlib decompression of the tables dominated load time.  Set
        # KEVLAR_COMPRESS_SKETCH=1 to trade load speed for disk.
        # Device sketches stream table rows straight from device memory to
        # the file (KEVLAR_STREAM_SAVE=0 disables): peak extra host memory
        # is one unpacked table row instead of a persistent full-table
        # mirror (the round-4 helium run held 5.9 GB of such mirrors).
        import os
        if (self.backend != 'host'
                and os.environ.get('KEVLAR_STREAM_SAVE', '1') != '0'
                and os.environ.get('KEVLAR_COMPRESS_SKETCH') != '1'):
            return self._save_streamed(filename)
        saver = np.savez_compressed \
            if os.environ.get('KEVLAR_COMPRESS_SKETCH') == '1' else np.savez
        saver(filename if filename.endswith('.npz') else filename,
              tables=self._host(), ksize=self._ksize,
              tablesize=self.tablesize, ntables=self.ntables,
              counter_bits=self.counter_bits,
              n_occupied=self.n_occupied())
        # numpy appends .npz; rename to the requested (extension-typed) name
        if not filename.endswith('.npz') and os.path.exists(filename + '.npz'):
            os.replace(filename + '.npz', filename)

    def _save_streamed(self, filename):
        """Write the npz row by row from device memory: one
        ``dynamic_slice`` program pulls each packed table row (compiled
        once per table shape), the row unpacks chunk-wise on the host, and
        the bytes append to an incrementally written (np.load-compatible,
        ZIP_STORED) zip member.  No full-table host mirror is ever
        materialised."""
        import io
        import zipfile
        tables = self.tables           # snapshot: jax arrays are immutable
        meta = dict(ksize=self._ksize, tablesize=self.tablesize,
                    ntables=self.ntables, counter_bits=self.counter_bits,
                    n_occupied=self.n_occupied())
        with zipfile.ZipFile(filename, 'w', zipfile.ZIP_STORED) as zf:
            for name, val in meta.items():
                buf = io.BytesIO()
                np.save(buf, np.asarray(val))
                zf.writestr(name + '.npy', buf.getvalue())
            info = zipfile.ZipInfo('tables.npy', date_time=(1980, 1, 1,
                                                            0, 0, 0))
            with zf.open(info, 'w', force_zip64=True) as fh:
                header = {'descr': '|u1', 'fortran_order': False,
                          'shape': (self.ntables, self.tablesize)}
                np.lib.format.write_array_header_1_0(fh, header)
                grab = _row_grab_fn(tables.shape)
                for t in range(self.ntables):
                    row = np.asarray(grab(tables, t))[0]
                    fh.write(_np_unpack(row[None, :], self.counter_bits,
                                        self.tablesize).tobytes())

    @classmethod
    def load_file(cls, filename, backend='device'):
        data = _load_npz_mmap(filename)
        if data is None:
            data = np.load(filename, allow_pickle=False)
        tables = data['tables']
        sketch = cls(int(data['ksize']), int(data['tablesize']),
                     int(data['ntables']), int(data['counter_bits']),
                     tables=tables, backend=backend)
        # the loaded host tables are identical to what just shipped to the
        # device: keep them as the host mirror so occupancy/FPR and host
        # point lookups never pull the tables back over the wire
        if sketch.backend != 'host':
            sketch._host_tables = np.asarray(tables, dtype=np.uint8)
        if 'n_occupied' in data:
            sketch._n_occupied = int(data['n_occupied'])
        return sketch


@functools.lru_cache(maxsize=8)
def _row_grab_fn(shape):
    """Jitted single-row dynamic_slice: the row index is traced, so every
    row of every save shares one compiled program per table shape."""
    import jax

    @jax.jit
    def grab(tables, t):
        return jax.lax.dynamic_slice(tables, (t, 0), (1, shape[1]))
    return grab


def _load_npz_mmap(filename):
    """Zero-copy load of an uncompressed npz: map each array member
    directly from the zip (copy-on-write, so callers may mutate without
    touching the file).  ``np.load`` copies npz members through ~1 MB
    zipfile chunks — 60 s of pure Python memcpy for a bigsim trio's
    4.6 GB of sketches, vs ~0 here (pages fault in on first touch; the
    host point-query path touches only the buckets it reads).  Returns
    None when any member is compressed or otherwise unmappable (caller
    falls back to np.load)."""
    import zipfile
    try:
        zf = zipfile.ZipFile(filename)
    except (OSError, zipfile.BadZipFile):
        return None
    out = {}
    with zf, open(filename, 'rb') as fh:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                return None
            # the central directory's extra field can differ from the
            # local header's: read the local header for the true offset
            fh.seek(info.header_offset)
            hdr = fh.read(30)
            if len(hdr) < 30 or hdr[:4] != b'PK\x03\x04':
                return None
            nlen = int.from_bytes(hdr[26:28], 'little')
            elen = int.from_bytes(hdr[28:30], 'little')
            data_off = info.header_offset + 30 + nlen + elen
            fh.seek(data_off)
            # public header readers only: numpy's private
            # _read_array_header is gone from newer releases
            readers = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}
            try:
                version = np.lib.format.read_magic(fh)
                if version not in readers:
                    return None
                shape, fortran, dtype = readers[version](fh)
            except (ValueError, OSError):
                return None
            if dtype.hasobject:
                return None
            name = info.filename
            name = name[:-4] if name.endswith('.npy') else name
            if not shape:
                # 0-d scalars: tiny, read directly
                out[name] = np.fromfile(fh, dtype=dtype, count=1)[0]
            else:
                out[name] = np.memmap(filename, dtype=dtype, mode='c',
                                      offset=fh.tell(), shape=shape,
                                      order='F' if fortran else 'C')
    return out


def _device_mask_tables(mask):
    """Mask tables in the packed device layout (a host-backend mask stores
    unpacked counter values and must be packed before a device consume)."""
    if mask is None:
        return None
    if mask.backend == 'host':
        return jnp.asarray(_np_pack(mask.tables, mask.counter_bits))
    return mask.tables


def estimate_fpr(sketch):
    """(occupancy / min_table_size) ** ntables, as in the reference
    (/root/reference/kevlar/sketch.py:62-74)."""
    occ = float(sketch.n_occupied())
    fp_one = occ / min(sketch.hashsizes())
    return fp_one ** float(sketch.ntables)


GRAPH_EXTENSIONS = ('.ng', '.nodegraph', '.cg', '.countgraph',
                    '.scg', '.smallcountgraph')


def allocate(ksize, target_tablesize, num_tables=4, count=False, graph=False,
             smallcount=False):
    bits = (4 if smallcount else 8) if count else 1
    if graph:
        # khmer graph types hash with the reversible 2-bit code (and khmer
        # raises on reverse_hash for table types); graphs are control-plane
        # objects in kevlar, so the khmer-compatible host engine serves them
        from kevlar_tpu.oxli import OxliSketch
        return OxliSketch(ksize, target_tablesize, num_tables,
                          counter_bits=bits, hash_mode='twobit')
    return Sketch(ksize, target_tablesize, num_tables, counter_bits=bits)


def allocate_from_memory(ksize, memory, num_tables=4, counter_bits=8,
                         backend='device'):
    """khmer-parity sizing: tablesize = memory/ntables * buckets_per_byte.

    The 'device' backend (jitted scatter) is the right default on every
    platform: on an accelerator it is the fast path, and even on the CPU backend the
    XLA scatter beats numpy's per-batch bincount at production tablesizes
    (a bincount materialises an O(tablesize) histogram per batch — measured
    4x slower end-to-end on the 1 Mb trio benchmark).  The 'host' backend
    remains for small control-plane sketches where dispatch latency
    dominates (filter re-counts, call masks).
    """
    tablesize = int(memory) // num_tables * BUCKETS_PER_BYTE[counter_bits]
    # Force an ODD tablesize (khmer sizes its tables to primes for the
    # same reason): banding fixes h1 mod numbands, so a tablesize sharing
    # a factor with the (power-of-two) band count confines every band's
    # k-mers to 1/numbands of each table's buckets — measured 10x
    # false-count inflation in per-band tables (4.9% of absent k-mers
    # read >= 10) before this fix.
    if tablesize % 2 == 0:
        tablesize -= 1
    return Sketch(ksize, max(tablesize, 1), num_tables,
                  counter_bits=counter_bits, backend=backend)


# in-process cache of sketches this process itself counted and saved:
# multi-stage drivers (bigsim/bench tools calling several CLI mains in one
# process) would otherwise reload multi-GB tables from disk and re-ship
# them to the device one stage after writing them.  The file's
# (mtime, size) is snapshotted on first use, so an externally modified
# file always reloads from disk.  Contract: a cache-served sketch is the
# SAME live object that was saved — callers must treat it as read-only
# (mutating it would silently diverge from the on-disk file; every
# in-repo consumer only queries).  The cache is bounded to the most
# recent _PROCESS_CACHE_MAX entries (insertion-ordered dict) so
# long-lived drivers counting many samples don't retain every multi-GB
# table for the process lifetime.
_process_cache = {}
_PROCESS_CACHE_MAX = 4


def _stat_key(filename):
    import os
    try:
        st = os.stat(filename)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def register_saved(filename, sketch):
    """Remember a sketch this process just persisted to ``filename``
    (possibly still being written by its save_async thread)."""
    import os
    path = os.path.abspath(filename)
    _process_cache.pop(path, None)
    _process_cache[path] = [sketch, None]
    while len(_process_cache) > _PROCESS_CACHE_MAX:
        evicted = next(iter(_process_cache))
        thread = getattr(_process_cache[evicted][0], '_save_thread', None)
        if thread is not None:
            thread.join()
        del _process_cache[evicted]


def _cached_load(filename):
    import os
    path = os.path.abspath(filename)
    entry = _process_cache.get(path)
    if entry is None:
        return None
    sketch, key = entry
    thread = getattr(sketch, '_save_thread', None)
    if thread is not None:
        thread.join()
        sketch._save_thread = None
    if key is None:
        entry[1] = key = _stat_key(path)
    if key is not None and key == _stat_key(path):
        return sketch
    del _process_cache[path]  # file changed on disk since we wrote it
    return None


def load(filename, backend='device', cache=True):
    """Load a sketch file.  ``backend='host'`` keeps the counters as a
    (copy-on-write memory-mapped) numpy array instead of shipping them to
    the device — for point-query-only consumers (simlike) where a full
    table upload would dominate the stage wall.  Ignored for khmer-format
    files (their engine is host-side).  ``cache=False`` skips the
    in-process cache (callers that specifically want the mmap-backed
    on-disk view rather than a live device object)."""
    import os
    extensions = tuple(COUNTER_BITS_BY_EXTENSION)
    if not filename.endswith(extensions):
        message = 'unable to determine sketch type from filename ' + filename
        raise KevlarSketchTypeError(message)
    if cache:
        cached = _cached_load(filename)
        if cached is not None:
            return cached
    else:
        # still honor an in-flight async save of this very file
        entry = _process_cache.get(os.path.abspath(filename))
        if entry is not None:
            thread = getattr(entry[0], '_save_thread', None)
            if thread is not None:
                thread.join()
                entry[0]._save_thread = None
    from kevlar_tpu import oxli
    if oxli.is_oxli_file(filename):
        # khmer-format sketch from the reference toolchain: load through
        # the bit-exact compatibility engine (hash + primes + layout);
        # graph-type extensions imply khmer's reversible 2-bit hash
        sk = oxli.OxliSketch.load(filename)
        if filename.endswith(GRAPH_EXTENSIONS):
            sk.hash_mode = 'twobit'
        return sk
    sketch = Sketch.load_file(filename, backend=backend)
    ext = '.' + filename.split('.')[-1]
    expected_bits = COUNTER_BITS_BY_EXTENSION[ext]
    if sketch.counter_bits != expected_bits:
        message = 'sketch "{}" has {}-bit counters but extension {} implies {}'
        raise KevlarSketchTypeError(message.format(
            filename, sketch.counter_bits, ext, expected_bits))
    return sketch


def autoload(infile, count=True, graph=False, ksize=31, table_size=1e4,
             num_tables=4, num_bands=None, band=None):
    """Load a sketch file, or build one from FASTA/FASTQ input."""
    try:
        return load(infile)
    except KevlarSketchTypeError:
        sketch = allocate(ksize, table_size, num_tables, count=count,
                          graph=graph, smallcount=False)
        if graph:
            # khmer-engine object: its own (khmer-semantics) consume;
            # library-level band indices are 0-based, as in the reference
            sketch.consume_seqfile(infile, numbands=num_bands, band=band)
            return sketch
        from kevlar_tpu import count as count_mod
        count_mod.consume_seqfile(sketch, [infile], numbands=num_bands,
                                  band=band)
        return sketch


def load_sketchfiles(sketchfiles, maxfpr=0.2):
    from kevlar_tpu import plog
    sketches = []
    for sketchfile in sketchfiles:
        plog('[kevlar::sketch]     loading sketchfile "{}"...'.format(
            sketchfile))
        sketch = autoload(sketchfile)
        fpr = estimate_fpr(sketch)
        message = 'estimated false positive rate is {:1.3f}'.format(fpr)
        if fpr > maxfpr:
            message += ' (FPR too high, bailing out!!!)'
            raise KevlarUnsuitableFPRError(message)
        plog('[kevlar::sketch]     ' + message)
        sketches.append(sketch)
    return sketches


class BandedSketchView:
    """Host-side read-only view over N per-band sketch files.

    Point queries route each k-mer to its band's table with the same
    hash-space predicate the banded count used (``h1 & (numbands-1)``,
    docs/banding.rst analog).  This closes the banded pipeline end to
    end: the reference's simlike has no banded mode (its published runs
    loaded full tables into RAM), while here the N band files mmap in
    lazily, so scoring at banded scale touches only the queried buckets.
    """

    def __init__(self, sketches):
        n = len(sketches)
        if n & (n - 1):
            raise ValueError('numbands must be a power of two')
        ksizes = {s.ksize() for s in sketches}
        if len(ksizes) != 1:
            raise ValueError('band sketches disagree on ksize')
        self._sketches = list(sketches)
        self._numbands = n
        self._ksize = ksizes.pop()

    @classmethod
    def load(cls, filenames, backend='host'):
        return cls([load(f, backend=backend, cache=False)
                    for f in filenames])

    def ksize(self):
        return self._ksize

    def get_kmer_counts(self, seq):
        """Counts for every k-mer of ``seq`` (invalid windows -> 0), each
        answered by its owning band's table."""
        h1, h2, valid = dna.kmer_hashes(dna.encode(seq), self._ksize)
        band = h1 & np.uint32(self._numbands - 1)
        counts = np.zeros(h1.shape, dtype=np.int64)
        for b, sk in enumerate(self._sketches):
            sel = valid & (band == b)
            if not sel.any():
                continue
            counts[sel] = sk._host_counts(h1[sel], h2[sel])
        return [int(c) for c in counts]

    def get(self, kmer):
        h1, h2 = dna.hash_kmer(kmer)
        b = int(np.uint32(h1) & np.uint32(self._numbands - 1))
        return self._sketches[b].get(kmer)
