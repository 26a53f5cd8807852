"""Coverage for support components: cigar endcheck, VCF writer details,
gz-aware open, GML output, mutable string, timers."""

import io
import os

import pytest

import kevlar_tpu
from kevlar_tpu.cigar import AlignmentTokenizer
from kevlar_tpu.support import MutableString
from kevlar_tpu.vcf import Variant, VCFWriter, VCFReader, VariantFilter


def test_cigar_tokenize_blocks():
    #       target: 5D + 10M + 3D ; query: 10M
    tok = AlignmentTokenizer('Q' * 10, 'T' * 18, '5D10M3D')
    types = [b.type for b in tok.blocks]
    assert types == ['D', 'M', 'D']
    assert tok.blocks[1].target == 'T' * 10
    assert tok.blocks[1].query == 'Q' * 10


def test_cigar_endcheck_merges_trailing_match():
    # 50D 98M 50D 2M where the trailing M's query matches the start of the
    # (D target + M target) -> canonicalised to 50D 100M 50D
    target = 'A' * 50 + 'C' * 98 + ('CC' + 'G' * 48) + 'GG'
    query = 'C' * 100
    tok = AlignmentTokenizer(query, target, '50D98M50D2M')
    assert tok.cigar == '50D100M50D'


def test_cigar_endcheck_realistic():
    import random
    from tests import simdata
    from kevlar_tpu.ops.align import align_numpy
    rng = random.Random(31)
    g = simdata.make_genome(rng, 200)
    contig = g[50:150]
    cigar, score = align_numpy(g, contig)
    assert cigar == '50D98M50D2M'  # ksw2 trailing-M artifact
    tok = AlignmentTokenizer(contig, g, cigar)
    assert tok.cigar == '50D100M50D'
    assert tok.blocks[1].length == 100


def test_vcf_writer_info_order_and_contig_last():
    out = io.StringIO()
    v = Variant('chr1', 99, 'A', 'T', CONTIG='ACGT', CIGAR='100M',
                KSW2='95', ALTWINDOW='AATAA')
    w = VCFWriter(out)
    w.write(v)
    line = out.getvalue().strip()
    fields = line.split('\t')
    assert fields[0] == 'chr1'
    assert fields[1] == '100'  # 1-based on write
    info = fields[7]
    assert info.endswith('CONTIG=ACGT')  # CONTIG printed last
    assert info.startswith('ALTWINDOW=AATAA;CIGAR=100M;KSW2=95')


def test_vcf_filter_strings():
    v = Variant('chr1', 5, 'A', 'T')
    assert v.filterstr == 'PASS'
    v.filter(VariantFilter.PassengerVariant)
    v.filter(VariantFilter.Homopolymer)
    assert v.filterstr == 'Homopolymer;PassengerVariant'
    nocall = Variant('chr1', 5, '.', '.')
    assert nocall.filterstr == '.'


def test_vcf_reader_samples_and_format():
    text = (
        '##fileformat=VCFv4.2\n'
        '#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tKid\tMom\n'
        'chr1\t100\t.\tA\tT\t.\tPASS\tLIKESCORE=12.5\t'
        'ALTABUND\t5,6\t0,0\n'
    )
    reader = VCFReader(io.StringIO(text))
    variants = list(reader)
    assert reader._sample_labels == ['Kid', 'Mom']
    v = variants[0]
    assert v.position == 99
    assert v.format('Kid', 'ALTABUND') == '5,6'
    assert v.format('Mom', 'ALTABUND') == '0,0'


def test_open_gz_roundtrip(tmp_path):
    path = str(tmp_path / 'x.txt.gz')
    with kevlar_tpu.open(path, 'w') as fh:
        fh.write('hello\nworld\n')
    with kevlar_tpu.open(path, 'r') as fh:
        assert fh.read() == 'hello\nworld\n'
    with pytest.raises(ValueError):
        kevlar_tpu.open(path, 'a')


def test_gml_output(tmp_path):
    from kevlar_tpu.readgraph import ReadGraph, to_gml
    g = ReadGraph()
    g.add_node('a')
    g.add_node('b')
    g.add_edge('a', 'b', offset=1)
    path = str(tmp_path / 'graph.gml')
    to_gml(g, path)
    text = open(path).read()
    assert 'node [ id 0 label "a" ]' in text
    assert 'edge [ source 0 target 1 ]' in text


def test_mutable_string():
    m = MutableString('ACGT')
    m[1] = 'T'
    assert str(m) == 'ATGT'
    m[1:3] == 'TG'
    del m[0]
    assert str(m) == 'TGT'
    m += 'AA'
    assert str(m) == 'TGTAA'
    assert 'GTA' in m
    assert len(m) == 5


def test_timer_and_progress():
    t = kevlar_tpu.Timer()
    t.start()
    t.start('phase')
    assert t.probe('phase') >= 0
    assert t.stop('phase') >= 0
    assert t.stop() >= 0
    with pytest.raises(ValueError):
        t.stop('nope')
    with pytest.raises(ValueError):
        t.start()  # already started
    p = kevlar_tpu.ProgressIndicator('processed {counter}', interval=2)
    for _ in range(5):
        p.update()
    assert p.counter == 5


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compile_cache_dir(env, cwd):
    """jax_compilation_cache_dir after `import jax; import kevlar_tpu` in
    a fresh process: a JAX imported first has already read its
    environment, so the package's default must go through jax.config."""
    import subprocess
    import sys as _sys
    env = dict(env, JAX_PLATFORMS='cpu',
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [env.get('PYTHONPATH')] if p]))
    out = subprocess.run(
        [_sys.executable, '-c',
         'import jax\nimport kevlar_tpu\n'
         'print(jax.config.jax_compilation_cache_dir)'],
        env=env, cwd=cwd, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_compilation_cache_dir_from_env_is_used_verbatim(tmp_path):
    mine = str(tmp_path / 'my cache')
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=mine)
    assert _compile_cache_dir(env, cwd=str(tmp_path)) == mine


def test_compilation_cache_defaults_to_the_checkout(tmp_path):
    """Unset, the cache is <checkout>/.jax_cache whatever HOME and the
    working directory are (the path is part of every cache key)."""
    env = dict(os.environ, HOME=str(tmp_path / 'home'))
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    want = os.path.join(REPO, '.jax_cache')
    assert _compile_cache_dir(env, cwd=str(tmp_path)) == want
    assert _compile_cache_dir(env, cwd=REPO) == want


def test_batch_reads_env_knob():
    """KEVLAR_BATCH_READS resizes the per-dispatch read batch."""
    import subprocess
    import sys as _sys
    env = dict(os.environ, KEVLAR_BATCH_READS='16384', JAX_PLATFORMS='cpu')
    out = subprocess.run(
        [_sys.executable, '-c',
         'from kevlar_tpu.batch import DEFAULT_BATCH_SIZE; '
         'print(DEFAULT_BATCH_SIZE)'],
        env=env, capture_output=True, text=True)
    assert out.stdout.strip() == '16384', out.stderr


def test_batch_reads_env_knob_rejects_bad_values():
    """A non-numeric or non-positive KEVLAR_BATCH_READS fails with a clear
    message naming the env var (not an opaque int() traceback)."""
    import subprocess
    import sys as _sys
    for bad in ('banana', '0', '-4'):
        env = dict(os.environ, KEVLAR_BATCH_READS=bad, JAX_PLATFORMS='cpu')
        out = subprocess.run(
            [_sys.executable, '-c', 'import kevlar_tpu.batch'],
            env=env, capture_output=True, text=True)
        assert out.returncode != 0
        assert 'KEVLAR_BATCH_READS' in out.stderr, out.stderr


class TestMutsim:
    """mutsim parity: the batched histogram program vs a literal
    per-position replica of the reference's snv.cpp/del.cpp loops."""

    @staticmethod
    def _trio(k=7, n=400):
        import random
        import numpy as np
        from kevlar_tpu.sketch import Sketch
        rng = random.Random(77)
        genome = ''.join(rng.choice('ACGT') for _ in range(n))
        ct = Sketch(k, 10007, 4, counter_bits=8, backend='host')
        ct.consume(genome)
        return genome, ct

    @staticmethod
    def _scalar_hists(genome, ct, k, muttype, delsize=3, histmax=16):
        import numpy as np
        abund = np.zeros(histmax + 1, np.int64)
        unique = np.zeros(k + 1, np.int64)
        N = len(genome)
        hi = (N - k + 1) if muttype == 'snv' else (N - k - delsize + 1)
        for i in range(k - 1, hi):
            if muttype == 'snv':
                window = genome[i - k + 1:i + k]
                for bp in 'ACGT':
                    if bp == window[k - 1]:
                        continue
                    mutseq = window[:k - 1] + bp + window[k:]
                    counts = ct.get_kmer_counts(mutseq)
                    uniq = 0
                    for c in counts:
                        abund[min(c, histmax)] += 1
                        uniq += (c == 0)
                    unique[uniq] += 1
            else:
                delseq = genome[i - k + 1:i] + \
                    genome[i + delsize:i + delsize + k]
                counts = ct.get_kmer_counts(delseq)
                uniq = 0
                for c in counts:
                    abund[min(c, histmax)] += 1
                    uniq += (c == 0)
                unique[uniq] += 1
        return abund, unique

    def test_snv_matches_scalar_replica(self):
        from kevlar_tpu.mutsim import mutsim
        genome, ct = self._trio()
        a, u = mutsim([genome], ct, muttype='snv', batch=64)
        ea, eu = self._scalar_hists(genome, ct, 7, 'snv')
        assert (a == ea).all() and (u == eu).all()

    def test_del_matches_scalar_replica(self):
        from kevlar_tpu.mutsim import mutsim
        genome, ct = self._trio()
        a, u = mutsim([genome], ct, muttype='del', delsize=3, batch=64)
        ea, eu = self._scalar_hists(genome, ct, 7, 'del', delsize=3)
        assert (a == ea).all() and (u == eu).all()

    def test_device_sketch_matches_host(self):
        from kevlar_tpu.batch import batches_from_records
        from kevlar_tpu.mutsim import mutsim
        from kevlar_tpu.sequence import Record
        from kevlar_tpu.sketch import Sketch
        genome, host_ct = self._trio()
        dev_ct = Sketch(7, 10007, 4, counter_bits=8)
        dev_ct.consume(genome)
        dev_ct._host_tables = None   # force the query_batch path
        a1, u1 = mutsim([genome], host_ct, muttype='snv', batch=64)
        a2, u2 = mutsim([genome], dev_ct, muttype='snv', batch=64)
        assert (a1 == a2).all() and (u1 == u2).all()


def test_banded_sketch_view_routes_queries_to_owning_band():
    """BandedSketchView answers every k-mer from its owning band's table
    (h1 & (N-1), the banded-count split).  Counts can differ from an
    unbanded table only by CMS collision structure (bands have FEWER
    collisions), so the truth anchor is the per-band table itself."""
    import random
    import numpy as np
    from kevlar_tpu.sketch import Sketch, BandedSketchView
    from kevlar_tpu import dna
    rng = random.Random(99)
    reads = [''.join(rng.choice('ACGT') for _ in range(90))
             for _ in range(300)]
    bands = [Sketch(25, 50021, 4, counter_bits=8, backend='host')
             for _ in range(4)]
    for r in reads:
        h1, h2, valid = dna.kmer_hashes(dna.encode(r), 25)
        for b, sk in enumerate(bands):
            sel = valid & ((h1 & np.uint32(3)) == b)
            sk._host_consume_hashes(h1, h2, sel)
    view = BandedSketchView(bands)
    assert view.ksize() == 25
    for r in reads[:40]:
        got = view.get_kmer_counts(r)
        h1, _, valid = dna.kmer_hashes(dna.encode(r), 25)
        for i in range(len(got)):
            if not valid[i]:
                assert got[i] == 0
                continue
            kmer = r[i:i + 25]
            b = int(np.uint32(h1[i]) & np.uint32(3))
            assert got[i] == bands[b].get(kmer)
            assert got[i] >= 1            # every k-mer was counted once+
            assert view.get(kmer) == got[i]
