"""khmer/oxli-compatible sketch layer: bit-exact interop with the reference.

The device :class:`kevlar_tpu.sketch.Sketch` uses its own all-uint32
canonical hash and an npz on-disk format.  This module
provides the *compatibility* counterpart: sketches that reproduce khmer's
Counttable / SmallCounttable / Nodetable **byte-for-byte** — same hash
function, same prime table sizes, same binary file format — so that

- sketch files written by the reference toolchain load here (and vice
  versa): a migrating user's ``.ct``/``.sct``/``.nt`` files keep working;
- the reference's pinned outputs that depend on sketch false-positive
  noise (e.g. its published simlike LIKESCOREs) are reproducible exactly.

Scheme (validated byte-exact against the reference's checked-in
``minitrio/trio-proband-mask-counts.ct``, which the reference's own suite
pins as the output of a masked count of ``trio-proband.fq.gz``):

- hash(kmer) = murmur3_x64_128(kmer, seed=0)[0]
               XOR murmur3_x64_128(revcomp(kmer), seed=0)[0]
  (strand-neutral by construction; behavior spec from the khmer library
  the reference depends on — /root/reference/requirements.txt)
- table t bin = hash % prime_t, where the primes are the first ``ntables``
  primes strictly below the requested tablesize, descending (odd
  candidates from tablesize-1 downward);
- counters saturate at 255 / 15 / 1 for 8/4/1-bit tables; sub-byte
  counters pack LSB-first (bin i -> byte i//cpb, low bits first);
- file format 'OXLI' v4: magic, version byte, type byte (1=counttable,
  2=nodetable, 7=smallcounttable), [counttable only: use_bigcount byte],
  ksize uint32le, ntables uint8, occupied-bins-of-table-0 uint64le, then
  per table (size uint64le + packed bytes), and for counttables a
  trailing uint64le bigcount-entry count (0: bigcounts unsupported here).

This engine is host-side (vectorized numpy) by design: it exists for
interop and parity, not throughput — the device path is ``Sketch``.
"""

import gzip
import struct

import numpy as np

U64 = np.uint64

# murmur3_x64_128 round constants
_C1 = U64(0x87C37B91114253D5)
_C2 = U64(0x4CF5AD432745937F)

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b'ACGTacgt', b'TGCATGCA'):
    _COMPLEMENT[_a] = _b

# read cleaning for consume: uppercase, non-ACGT -> A (khmer consume
# normalization; the reference's pipelines skip non-ACGT reads before the
# sketch layer, so this is rarely observable)
_CLEAN = np.full(256, ord('A'), dtype=np.uint8)
for _a in b'ACGT':
    _CLEAN[_a] = _a
for _a, _b in zip(b'acgt', b'ACGT'):
    _CLEAN[_a] = _b

MAXCOUNT = {1: 1, 4: 15, 8: 255}
_TYPE_BY_BITS = {8: 1, 1: 2, 4: 7}
_BITS_BY_TYPE = {1: 8, 2: 1, 7: 4}


def _rotl(x, r):
    return (x << U64(r)) | (x >> U64(64 - r))


def _fmix(k):
    k ^= k >> U64(33)
    k *= U64(0xFF51AFD7ED558CCD)
    k ^= k >> U64(33)
    k *= U64(0xC4CEB9FE1A85EC53)
    k ^= k >> U64(33)
    return k


def murmur3_x64_128_h1(keys):
    """First 64-bit word of murmur3_x64_128 (seed 0) per row of a uint8
    [N, L] key matrix.  Vectorized over N."""
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    N, L = keys.shape
    nblocks = L // 16
    h1 = np.zeros(N, dtype=U64)
    h2 = np.zeros(N, dtype=U64)
    with np.errstate(over='ignore'):
        for b in range(nblocks):
            k1 = keys[:, b * 16:b * 16 + 8].copy().view('<u8').ravel().copy()
            k2 = keys[:, b * 16 + 8:b * 16 + 16].copy().view(
                '<u8').ravel().copy()
            k1 *= _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
            h1 = _rotl(h1, 27)
            h1 += h2
            h1 = h1 * U64(5) + U64(0x52DCE729)
            k2 *= _C2
            k2 = _rotl(k2, 33)
            k2 *= _C1
            h2 ^= k2
            h2 = _rotl(h2, 31)
            h2 += h1
            h2 = h2 * U64(5) + U64(0x38495AB5)
        tail = keys[:, nblocks * 16:]
        tl = L - nblocks * 16
        k1 = np.zeros(N, dtype=U64)
        k2 = np.zeros(N, dtype=U64)
        for i in range(8, tl):
            k2 |= tail[:, i].astype(U64) << U64(8 * (i - 8))
        if tl > 8:
            k2 *= _C2
            k2 = _rotl(k2, 33)
            k2 *= _C1
            h2 ^= k2
        for i in range(min(tl, 8)):
            k1 |= tail[:, i].astype(U64) << U64(8 * i)
        if tl > 0:
            k1 *= _C1
            k1 = _rotl(k1, 31)
            k1 *= _C2
            h1 ^= k1
        h1 ^= U64(L)
        h2 ^= U64(L)
        h1 += h2
        h2 += h1
        h1 = _fmix(h1)
        h2 = _fmix(h2)
        h1 += h2
    return h1


def hash_kmer_matrix(kmers):
    """Canonical (strand-neutral) khmer hashes of a uint8 [N, K] ASCII
    k-mer matrix: murmur(fwd) ^ murmur(revcomp)."""
    fwd = murmur3_x64_128_h1(kmers)
    rev = murmur3_x64_128_h1(_COMPLEMENT[kmers][:, ::-1])
    return fwd ^ rev


def hash_kmer(kmer):
    """Canonical khmer hash of one k-mer string."""
    arr = np.frombuffer(kmer.encode(), dtype=np.uint8)[None, :]
    return int(hash_kmer_matrix(arr)[0])


def sequence_kmer_hashes(seq, ksize, clean=False):
    """Hashes for every k-mer window of one sequence string.

    Returns (hashes uint64 [n], valid bool [n]); windows containing
    non-ACGT are invalid unless ``clean`` converts the bases to 'A' first.
    """
    data = np.frombuffer(seq.upper().encode(), dtype=np.uint8)
    if len(data) < ksize:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=bool)
    good = np.isin(data, np.frombuffer(b'ACGT', dtype=np.uint8))
    if clean:
        data = _CLEAN[data]
        good = np.ones(len(data), dtype=bool)
    win = np.lib.stride_tricks.sliding_window_view(data, ksize)
    valid = np.lib.stride_tricks.sliding_window_view(good, ksize).all(axis=1)
    return hash_kmer_matrix(win), valid


# ---- khmer graph-type hashing (reversible 2-bit; k <= 32) -----------------
# khmer's *graph classes hash with a reversible 2-bit code — A=0, T=1, C=2,
# G=3, complement = code^1 — taking min(forward, revcom); its *table
# classes use murmur.  The file formats are identical, so the engine picks
# the hash from the filename extension (as kevlar's sketch registry does).
_TWOBIT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate('ATCG'):
    _TWOBIT[ord(_b)] = _i
    _TWOBIT[ord(_b.lower())] = _i
_TWOBIT_CHARS = 'ATCG'


def twobit_hash_matrix(kmers):
    """Canonical khmer graph hashes of a uint8 [N, K] ASCII matrix."""
    codes = _TWOBIT[kmers].astype(U64)
    K = kmers.shape[1]
    if K > 32:
        raise ValueError('graph hashing supports k <= 32')
    fwd = np.zeros(kmers.shape[0], dtype=U64)
    rev = np.zeros(kmers.shape[0], dtype=U64)
    for i in range(K):
        fwd = (fwd << U64(2)) | codes[:, i]
        rev = (rev << U64(2)) | (codes[:, K - 1 - i] ^ U64(1))
    return np.minimum(fwd, rev)


def twobit_hash(kmer):
    arr = np.frombuffer(kmer.encode(), dtype=np.uint8)[None, :]
    return int(twobit_hash_matrix(arr)[0])


def twobit_sequence_hashes(seq, ksize, clean=False):
    data = np.frombuffer(seq.upper().encode(), dtype=np.uint8)
    if len(data) < ksize:
        return np.zeros(0, dtype=U64), np.zeros(0, dtype=bool)
    good = np.isin(data, np.frombuffer(b'ACGT', dtype=np.uint8))
    if clean:
        data = _CLEAN[data]
        good = np.ones(len(data), dtype=bool)
    win = np.lib.stride_tricks.sliding_window_view(data, ksize)
    valid = np.lib.stride_tricks.sliding_window_view(good, ksize).all(axis=1)
    return twobit_hash_matrix(win), valid


def twobit_reverse_hash(value, ksize):
    """Decode a graph hash back to (one strand of) its k-mer."""
    chars = []
    v = int(value)
    for _ in range(ksize):
        chars.append(_TWOBIT_CHARS[v & 3])
        v >>= 2
    return ''.join(reversed(chars))


def is_prime(n):
    """Deterministic Miller-Rabin for 64-bit inputs."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def primes_below(x, n):
    """First ``n`` primes strictly below ``x``, descending — khmer's table
    sizing (odd candidates from x-1 downward; validated against the
    reference data files' stored sizes, e.g. 1e4 -> 9973 9967 9949 9941)."""
    x = int(x)
    i = x - 1
    if i % 2 == 0:
        i -= 1
    out = []
    while len(out) < n and i > 1:
        if is_prime(i):
            out.append(i)
        i -= 2
    if len(out) < n:
        raise ValueError('not enough primes below {}'.format(x))
    return out


def _pack(bins, bits):
    if bits == 8:
        return bins
    if bits == 1:
        return np.packbits(bins.astype(bool), bitorder='little')
    # khmer NibbleStorage puts the EVEN bucket in the HIGH nibble
    # (empirically pinned: the reference's ctrl-high-abund /
    # case-low-abund / simlike-fast-mode .sct fixtures only reproduce the
    # reference suite's filter outcomes with this orientation —
    # tests/test_reference_parity_simlike.py)
    pad = (-len(bins)) % 2
    b = np.pad(bins, (0, pad))
    return ((b[0::2] << 4) | b[1::2]).astype(np.uint8)


def _unpack(packed, bits, size):
    if bits == 8:
        return packed[:size]
    if bits == 1:
        return np.unpackbits(packed, bitorder='little')[:size]
    out = np.empty(len(packed) * 2, dtype=np.uint8)
    out[0::2] = packed >> 4
    out[1::2] = packed & 0xF
    return out[:size]


class OxliSketch:
    """khmer-binary-compatible Count-Min sketch (host / numpy engine).

    ``tablesize`` may be the khmer-style target size (primes are derived)
    or an explicit list of table sizes (as stored in a file).
    """

    def __init__(self, ksize, tablesize, ntables=4, counter_bits=8,
                 hash_mode='murmur'):
        self._ksize = int(ksize)
        self.hash_mode = hash_mode  # 'murmur' (tables) | 'twobit' (graphs)
        self.counter_bits = int(counter_bits)
        self.maxcount = MAXCOUNT[self.counter_bits]
        if isinstance(tablesize, (list, tuple)):
            self.sizes = [int(s) for s in tablesize]
        else:
            self.sizes = primes_below(int(tablesize), int(ntables))
        self.ntables = len(self.sizes)
        self.tables = [np.zeros(s, dtype=np.uint8) for s in self.sizes]
        # khmer leaves the final byte's unused pad bits of sub-byte tables
        # uninitialized; preserved from load so re-saves stay byte-faithful
        self._pad_bits = [0] * self.ntables
        # exact distinct-k-mer counter (khmer parity); None once the
        # counting history is unknown (tables loaded from a file)
        self._n_unique = 0

    # -- khmer-parity introspection ------------------------------------
    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self.sizes)

    def n_occupied(self):
        return int(np.count_nonzero(self.tables[0]))

    def n_unique_kmers(self):
        """khmer-exact distinct-k-mer count when all counting went through
        this object (tracked per insert, khmer Storage semantics: a k-mer
        is new iff some bucket was still 0 when its first occurrence
        arrived); occupancy-based estimate for loaded tables."""
        if self._n_unique is not None:
            return self._n_unique
        occ = self.n_occupied()
        size = self.sizes[0]
        if occ >= size:
            return size
        return int(round(-size * np.log1p(-occ / size)))

    # -- hashing / queries -------------------------------------------------
    def hash(self, kmer):
        if self.hash_mode == 'twobit':
            return twobit_hash(kmer)
        return hash_kmer(kmer)

    def reverse_hash(self, value):
        """Graph hashes are reversible (2-bit code); table (murmur)
        hashes are not — khmer raises the same error."""
        if self.hash_mode != 'twobit':
            raise ValueError('reverse hashing not implemented for '
                             'murmur-hashed sketches')
        return twobit_reverse_hash(value, self._ksize)

    def _seq_hashes(self, seq, clean=False):
        if self.hash_mode == 'twobit':
            return twobit_sequence_hashes(seq, self._ksize, clean=clean)
        return sequence_kmer_hashes(seq, self._ksize, clean=clean)

    def _matrix_hashes(self, kmers):
        if self.hash_mode == 'twobit':
            return twobit_hash_matrix(kmers)
        return hash_kmer_matrix(kmers)

    def get_kmers(self, seq):
        k = self._ksize
        return [seq[i:i + k] for i in range(len(seq) - k + 1)]

    def _counts_for_hashes(self, hashes):
        counts = None
        for size, table in zip(self.sizes, self.tables):
            c = table[(hashes % U64(size)).astype(np.int64)]
            counts = c if counts is None else np.minimum(counts, c)
        if counts is None:
            return np.zeros(len(hashes), dtype=np.uint8)
        return counts

    def get(self, kmer):
        return int(self._counts_for_hashes(
            np.array([self.hash(kmer)], dtype=U64))[0])

    def get_kmer_counts(self, seq):
        hashes, valid = self._seq_hashes(seq)
        counts = self._counts_for_hashes(hashes)
        return [int(c) if v else 0 for c, v in zip(counts, valid)]

    def get_kmer_hashes(self, seq):
        hashes, valid = self._seq_hashes(seq)
        return [int(h) for h, v in zip(hashes, valid) if v]

    # -- counting -----------------------------------------------------------
    def _track_new_kmers(self, hashes):
        """Count hashes khmer would report as new: at its first occurrence
        a k-mer is new iff some table bucket is still 0 — including buckets
        touched earlier in this same batch by OTHER new k-mers (khmer
        inserts strictly sequentially; replicated here with a touched-set
        over the batch's first occurrences, in stream order)."""
        uniq, first = np.unique(hashes, return_index=True)
        order = np.argsort(first, kind='stable')
        uniq = uniq[order]
        idx_per_table = [(uniq % U64(size)).astype(np.int64)
                         for size in self.sizes]
        pre_zero = [self.tables[t][idx_per_table[t]] == 0
                    for t in range(self.ntables)]
        candidates = np.nonzero(
            np.logical_or.reduce(pre_zero) if pre_zero else
            np.zeros(len(uniq), bool))[0]
        touched = set()
        nnew = 0
        for u in candidates:
            fresh = False
            buckets = []
            for t in range(self.ntables):
                key = (t, int(idx_per_table[t][u]))
                buckets.append(key)
                if pre_zero[t][u] and key not in touched:
                    fresh = True
            if fresh:
                nnew += 1
                touched.update(buckets)
        return nnew

    def _consume_hashes(self, hashes):
        if self._n_unique is not None and len(hashes):
            self._n_unique += self._track_new_kmers(hashes)
        for size, table in zip(self.sizes, self.tables):
            idx = (hashes % U64(size)).astype(np.int64)
            inc = np.bincount(idx, minlength=size)
            table[:] = np.minimum(table.astype(np.int64) + inc,
                                  self.maxcount).astype(np.uint8)
        return len(hashes)

    def add(self, kmer):
        return self._consume_hashes(np.array([self.hash(kmer)], dtype=U64))

    count = add

    def consume(self, seq):
        hashes, valid = self._seq_hashes(seq)
        return self._consume_hashes(hashes[valid])

    def consume_seqfile(self, path, mask=None, threshold=1,
                        consume_masked=False, numbands=None, band=None,
                        chunk_reads=2048):
        """Count every k-mer of a FASTA/FASTQ[.gz] file, khmer-style
        (reads cleaned: non-ACGT -> 'A').  Masking counts a k-mer iff its
        mask abundance is >= threshold (``consume_masked``) or below it
        (mask-exclusion).  Banding keeps hashes inside khmer's hash-range
        band (band b of N covers [b*(2^64//N), (b+1)*(2^64//N)), 0-based —
        khmer's ``consume_seqfile_banding`` semantics, byte-pinned against
        the reference's ``simple-genome-case-band-*.ct`` fixtures; note
        this differs from the novel stage's in-loop power-of-two mask
        check, exactly as in the reference).  Returns (n_reads, n_kmers).
        """
        from kevlar_tpu import seqio
        nreads = 0
        nkmers = 0
        chunk = []
        for record in seqio.multi_file_iter([path]):
            chunk.append(record.sequence)
            nreads += 1
            if len(chunk) >= chunk_reads:
                nkmers += self._consume_seq_chunk(
                    chunk, mask, threshold, consume_masked, numbands, band)
                chunk = []
        if chunk:
            nkmers += self._consume_seq_chunk(
                chunk, mask, threshold, consume_masked, numbands, band)
        return nreads, nkmers

    def _consume_seq_chunk(self, seqs, mask, threshold, consume_masked,
                           numbands, band):
        k = self._ksize
        joined = ('N' * k).join(s for s in seqs if len(s) >= k)
        if len(joined) < k:
            return 0
        data = _CLEAN[np.frombuffer(joined.encode(), dtype=np.uint8)]
        # windows crossing the N-spacers belong to no read: mark them out
        # before cleaning maps the spacer to 'A'
        sep = np.frombuffer(joined.encode(), dtype=np.uint8) == ord('N')
        win = np.lib.stride_tricks.sliding_window_view(data, k)
        valid = ~np.lib.stride_tricks.sliding_window_view(sep, k).any(axis=1)
        hashes = self._matrix_hashes(win[valid])
        if numbands:
            step = 2 ** 64 // numbands
            lo = U64(step * band)
            keep = hashes >= lo
            if band + 1 < numbands:
                keep &= hashes < U64(step * (band + 1))
            hashes = hashes[keep]
        if mask is not None:
            mcounts = mask._counts_for_hashes(hashes)
            if consume_masked:
                hashes = hashes[mcounts >= threshold]
            else:
                hashes = hashes[mcounts < threshold]
        return self._consume_hashes(hashes)

    def abundance_distribution(self, records, tracking):
        """Histogram of distinct-k-mer abundances over the records' k-mers
        (khmer ``abundance_distribution``; ``tracking`` dedups)."""
        from kevlar_tpu import seqio
        if isinstance(records, str):
            records = seqio.multi_file_iter([records])
        hist = np.zeros(256, dtype=np.int64)
        for record in records:
            hashes, valid = self._seq_hashes(record.sequence,
                                             clean=True)
            hashes = np.unique(hashes[valid])
            if not len(hashes):
                continue
            fresh = tracking._counts_for_hashes(hashes) == 0
            if not fresh.any():
                continue
            counts = self._counts_for_hashes(hashes[fresh])
            np.add.at(hist, counts.astype(np.int64), 1)
            tracking._consume_hashes(hashes[fresh])
        return hist

    # -- persistence ---------------------------------------------------------
    def save(self, filename):
        ftype = _TYPE_BY_BITS[self.counter_bits]
        out = [b'OXLI', bytes([4, ftype])]
        if ftype == 1:
            out.append(bytes([0]))  # use_bigcount: not supported here
        out.append(struct.pack('<IB', self._ksize, self.ntables))
        out.append(struct.pack('<Q', self.n_occupied()))
        for size, table, pad in zip(self.sizes, self.tables, self._pad_bits):
            out.append(struct.pack('<Q', size))
            packed = _pack(table, self.counter_bits)
            if pad:
                packed = packed.copy()
                packed[-1] |= pad
            out.append(packed.tobytes())
        if ftype == 1:
            out.append(struct.pack('<Q', 0))  # no bigcount entries
        opener = gzip.open if filename.endswith('.gz') else open
        with opener(filename, 'wb') as fh:
            fh.write(b''.join(out))

    @classmethod
    def load(cls, filename):
        opener = gzip.open if filename.endswith('.gz') else open
        with opener(filename, 'rb') as fh:
            data = fh.read()
        if data[:4] != b'OXLI':
            raise ValueError('not an OXLI sketch file: ' + filename)
        ftype = data[5]
        if ftype not in _BITS_BY_TYPE:
            raise ValueError(
                'unsupported OXLI file type {}'.format(ftype))
        bits = _BITS_BY_TYPE[ftype]
        off = 6
        if ftype == 1:
            use_bigcount = data[off]
            off += 1
            if use_bigcount:
                raise ValueError('bigcount counttables are not supported')
        ksize, ntables = struct.unpack_from('<IB', data, off)
        off += 5
        off += 8  # stored occupied-bin count; recomputed on demand
        sizes = []
        tables = []
        pads = []
        cpb = {8: 1, 4: 2, 1: 8}[bits]
        for _ in range(ntables):
            size, = struct.unpack_from('<Q', data, off)
            off += 8
            nbytes = -(-size // cpb)
            packed = np.frombuffer(data[off:off + nbytes], dtype=np.uint8)
            off += nbytes
            sizes.append(size)
            table = _unpack(packed, bits, size)
            tables.append(table)
            pads.append(int(packed[-1]) & ~int(_pack(table, bits)[-1])
                        if nbytes else 0)
        sketch = cls(ksize, sizes, counter_bits=bits)
        sketch.tables = [t.copy() for t in tables]
        sketch._pad_bits = pads
        sketch._n_unique = None  # counting history unknown: estimate
        return sketch


def is_oxli_file(filename):
    opener = gzip.open if filename.endswith('.gz') else open
    try:
        with opener(filename, 'rb') as fh:
            return fh.read(4) == b'OXLI'
    except (OSError, EOFError):
        return False
