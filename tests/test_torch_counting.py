"""The port's counting path (bear_tpu_torch.counting + ops.alphabets) against
bear_tpu's, on the CPU.

Tables from ``bear_tpu_torch``'s ``TransitionCounter(device="cpu")`` must be
bit-equal to bear_tpu's ``TransitionCounter`` with ``method="scatter"`` and
with ``method="sorted"`` (the Pallas kernel in interpret mode). Inputs are
made with numpy from a seed.
"""

import gzip

import numpy as np
import pytest
import torch

from bear_tpu.counting import engine as jengine
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting import pallas_hist as ph
from bear_tpu.ops import alphabets as jalpha
from bear_tpu_torch.counting import engine, fastx
from bear_tpu_torch.ops import alphabets

torch.set_num_threads(2)


@pytest.fixture
def interpret():
    old = ph.INTERPRET
    ph.INTERPRET = True
    yield
    ph.INTERPRET = old


def _rand_seq(rng, n, letters="ACGT"):
    return "".join(rng.choice(list(letters), size=n))


def _random_reads(rng, n=40, lo=1, hi=40):
    return [(rng.integers(0, 4, size=int(rng.integers(lo, hi))).astype(np.int8),
             int(rng.integers(0, 2))) for _ in range(n)]


def _reads_with_ambig(rng):
    out = []
    for i in range(30):
        s = list(_rand_seq(rng, int(rng.integers(5, 40))))
        for p in rng.choice(len(s), size=int(rng.integers(0, 3)), replace=False):
            s[p] = "N"
        if i == 0:
            s = list("ACGTN")      # trailing N: one piece, fresh, not stopped
        if i == 1:
            s = list("NNACGTAC")   # leading N run
        out.append((fastx.encode_seq("".join(s), ambig=True), i % 2))
    return list(engine.split_ambiguous(out))


# Each case: (lags, n_groups, reverse, alphabet, chunk list builder).
def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "lags_1_3_5":
        reads = _random_reads(rng)
        return (1, 3, 5), 2, False, "dna", list(engine.chunk_reads(iter(reads), 5, batch_size=16))
    if name == "reverse":
        reads = _random_reads(rng)
        return (1, 3, 5), 2, True, "dna", list(engine.chunk_reads(iter(reads), 5, batch_size=16))
    if name == "ambig_pieces":
        return (1, 3, 5), 2, False, "dna", list(engine.chunk_reads(iter(_reads_with_ambig(rng)), 5, batch_size=16))
    if name == "ambig_pieces_reverse":
        return (3,), 2, True, "dna", list(engine.chunk_reads(iter(_reads_with_ambig(rng)), 3, batch_size=16))
    if name == "segmented_long_reads":
        reads = _random_reads(rng, n=6, lo=60, hi=200)
        return (1, 3, 5), 2, False, "dna", list(engine.chunk_reads(
            iter(reads), 5, batch_size=8, segment_len=16))
    if name == "segmented_rc_emitted":
        reads = _random_reads(rng, n=6, lo=60, hi=200)
        return (3, 5), 2, False, "dna", list(engine.chunk_reads(
            iter(reads), 5, batch_size=8, segment_len=16, reverse=True))
    if name == "shorter_than_lag":
        reads = [(np.zeros(0, np.int8), 0)] + _random_reads(rng, n=20, lo=1, hi=5)
        return (5,), 2, False, "dna", list(engine.chunk_reads(iter(reads), 5, batch_size=8))
    if name == "protein_lag2":
        reads = [(rng.integers(0, 20, size=int(rng.integers(1, 30))).astype(np.int8),
                  int(rng.integers(0, 2))) for _ in range(30)]
        return (2,), 2, False, "prot", list(engine.chunk_reads(iter(reads), 2, batch_size=16))
    raise KeyError(name)


CASES = ["lags_1_3_5", "reverse", "ambig_pieces", "ambig_pieces_reverse",
         "segmented_long_reads", "segmented_rc_emitted", "shorter_than_lag",
         "protein_lag2"]


def _transitions(chunks, lag):
    """Transitions the chunks should count at one lag: a numpy recount of
    the mask rules (independent of both engines)."""
    n = 0
    for c in chunks:
        j = np.arange(c.codes.shape[1] + 1)[None, :]
        m = (j >= c.skip[:, None]) & ((j < c.lengths[:, None])
                                      | ((j == c.lengths[:, None]) & c.stopped[:, None]))
        if c.fresh is not None:
            m &= c.fresh[:, None] | (j >= lag)
        n += int(m.sum())
    return n


@pytest.mark.parametrize("method", ["scatter", "sorted"])
@pytest.mark.parametrize("case", CASES)
def test_tables_bit_equal_to_bear_tpu(interpret, case, method):
    lags, G, reverse, alphabet, chunks = _case(case)
    ref = jengine.TransitionCounter(lags=lags, n_groups=G, reverse=reverse,
                                    method=method, alphabet=alphabet)
    port = engine.TransitionCounter(lags=lags, n_groups=G, reverse=reverse,
                                    alphabet=alphabet, device="cpu")
    for c in chunks:
        ref.add_chunk(c)
        port.add_chunk(c)
    want, got = ref.tables, port.tables
    for l in lags:
        assert got[l].dtype == np.int64
        np.testing.assert_array_equal(got[l], want[l])
    if all(c.fresh is None for c in chunks):
        # Conservation holds across lags only without per-lag fresh masks.
        want_n = _transitions(chunks, max(lags))
        assert port.validate(want_n) == ref.validate(want_n)
    for l in lags:
        np.testing.assert_array_equal(port.nonzero_rows(l), ref.nonzero_rows(l))


def test_chunk_builders_match_bear_tpu():
    rng = np.random.default_rng(5)
    reads = _random_reads(rng, n=12, lo=1, hi=120)
    pieces = _reads_with_ambig(rng)
    jpieces = list(jengine.split_ambiguous(
        [(fastx.encode_seq(s), g) for s, g in [("ACNNGT", 0), ("NACGTN", 1)]]))
    ppieces = list(engine.split_ambiguous(
        [(fastx.encode_seq(s), g) for s, g in [("ACNNGT", 0), ("NACGTN", 1)]]))
    assert [(p.tolist(), g, f, s) for p, g, f, s in jpieces] == \
        [(p.tolist(), g, f, s) for p, g, f, s in ppieces]
    for items, kw in [(reads, dict(segment_len=32)), (reads, dict(reverse=True)),
                      (pieces, dict(reverse=True))]:
        a = list(jengine.chunk_reads(iter(items), 5, batch_size=8, **kw))
        b = list(engine.chunk_reads(iter(items), 5, batch_size=8, **kw))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for f in ("codes", "lengths", "skip", "stopped", "groups", "fresh"):
                xa, ya = getattr(x, f), getattr(y, f)
                assert (xa is None) == (ya is None)
                if xa is not None:
                    np.testing.assert_array_equal(xa, ya)
            np.testing.assert_array_equal(
                engine.reverse_complement_codes(y.codes, y.lengths)[0],
                jengine.reverse_complement_codes(x.codes, x.lengths)[0])
            for u, v in zip(engine.rc_boundary_flags(y), jengine.rc_boundary_flags(x)):
                assert (u is None) == (v is None)
                if u is not None:
                    np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("lag,A", [(1, 4), (5, 4), (13, 4), (2, 20), (7, 20)])
def test_table_layout_matches_bear_tpu(lag, A):
    assert engine.table_rows(lag, A) == jengine.table_rows(lag, A)
    for n_pad in range(lag + 1):
        assert engine.pad_offset(lag, n_pad, A) == jengine.pad_offset(lag, n_pad, A)
    assert engine.lag_offsets((1, lag), 2, A) == jengine.lag_offsets((1, lag), 2, A)


@pytest.mark.parametrize("alphabet,lag", [("dna", 4), ("prot", 2)])
def test_context_row_codec_matches_bear_tpu(alphabet, lag):
    A = alphabets.alphabet_size(alphabet)
    rows = np.random.default_rng(3).integers(0, engine.table_rows(lag, A), 200)
    ctx = engine.rows_to_contexts(rows, lag, alphabet)
    np.testing.assert_array_equal(ctx, jengine.rows_to_contexts(rows, lag, alphabet))
    assert [engine.context_to_row(c, lag, alphabet) for c in ctx] == rows.tolist()
    assert [jengine.context_to_row(c, lag, alphabet) for c in ctx] == rows.tolist()


def test_check_groups_rejects_out_of_range():
    tc = engine.TransitionCounter(lags=[2], n_groups=2, device="cpu")
    chunk = engine.ReadChunk(np.zeros((2, 4), np.int8), np.array([4, 4], np.int32),
                             np.zeros(2, np.int32), np.ones(2, bool),
                             np.array([0, 2], np.int32))
    with pytest.raises(ValueError, match="group ids"):
        tc.add_chunk(chunk)
    chunk.groups = np.array([0, -1], np.int32)
    with pytest.raises(ValueError, match="group ids"):
        tc.add_chunk(chunk)
    assert tc.validate() == {2: 0}


def test_reverse_rejects_segmented_chunk():
    tc = engine.TransitionCounter(lags=[2], reverse=True, device="cpu")
    chunk = engine.ReadChunk(np.zeros((1, 4), np.int8), np.array([4], np.int32),
                             np.array([2], np.int32), np.ones(1, bool),
                             np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="skip"):
        tc.add_chunk(chunk)
    assert tc.validate() == {2: 0}


@pytest.mark.parametrize("lags,alphabet", [([16], "dna"), ([15], "dna"),
                                           ([8], "prot"), ([1, 14], "dna")])
def test_int32_guards(lags, alphabet):
    # 4^16 and 20^8 context codes exceed int32; the lag-15 table and the
    # lag-14 table behind a lag-1 table exceed int32 flat indexing.
    with pytest.raises(ValueError, match="int32"):
        engine.TransitionCounter(lags=lags, alphabet=alphabet, n_groups=2,
                                 device="cpu")


def test_flush_routes_and_merge_match_bear_tpu():
    rng = np.random.default_rng(11)
    # Dense route: lag 1 table (2 x 5 x 5) is mostly nonzero after a chunk;
    # sparse route: lag 6 table stays sparse.
    chunks = list(engine.chunk_reads(iter(_random_reads(rng, n=64)), 6, batch_size=16))
    ref = jengine.TransitionCounter(lags=(1, 6), n_groups=2, method="scatter")
    port = engine.TransitionCounter(lags=(1, 6), n_groups=2, device="cpu")
    port.FLUSH_EVERY = 700  # several automatic mid-stream flushes
    half = engine.TransitionCounter(lags=(1, 6), n_groups=2, device="cpu")
    for i, c in enumerate(chunks):
        ref.add_chunk(c)
        port.add_chunk(c)
        if i % 2 == 0:
            half.add_chunk(c)
    rest = engine.TransitionCounter(lags=(1, 6), n_groups=2, device="cpu")
    for c in chunks[1::2]:
        rest.add_chunk(c)
    half.merge_from(rest)
    for l in (1, 6):
        np.testing.assert_array_equal(port.tables[l], ref.tables[l])
        np.testing.assert_array_equal(half.tables[l], ref.tables[l])
    # Tables keep accumulating after a flush.
    port.add_chunk(chunks[0])
    ref.add_chunk(chunks[0])
    np.testing.assert_array_equal(port.tables[6], ref.tables[6])


def test_default_device_raises_without_cuda():
    # No silent CPU path: the default device is "cuda", and with no card the
    # first add_chunk raises instead of counting on the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device counts there")
    tc = engine.TransitionCounter(lags=[3])
    chunk = next(engine.chunk_reads(iter([(fastx.encode_seq("ACGTAC"), 0)]), 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.add_chunk(chunk)
    assert tc.validate() == {3: 0}


# --- host codecs -----------------------------------------------------------


@pytest.mark.parametrize("alphabet", ["dna", "rna", "prot"])
@pytest.mark.parametrize("ambig", [False, True])
def test_encode_seq_matches_bear_tpu(alphabet, ambig):
    rng = np.random.default_rng(1)
    letters = alphabets.residues(alphabet)
    s = _rand_seq(rng, 300, letters + letters.lower() + "NXB*")
    np.testing.assert_array_equal(fastx.encode_seq(s, alphabet, ambig),
                                  jfastx.encode_seq(s, alphabet, ambig))


def test_fastx_readers_match_bear_tpu(tmp_path):
    rng = np.random.default_rng(2)
    seqs = [_rand_seq(rng, int(rng.integers(1, 90)), "ACGTN") for _ in range(8)]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i} desc\r\n{s[:40]}\n{s[40:]}\n\n" for i, s in enumerate(seqs)))
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as fh:
        fh.write("".join(f"@q{i} x\n{s}\n+\n{'I' * len(s)}\n\n" for i, s in enumerate(seqs)))
    csv = tmp_path / "in.csv"
    csv.write_text("r.fa, 0, fa\nr.fq.gz,1,fq\n")
    assert list(fastx.iter_fasta(str(fa))) == list(jfastx.iter_fasta(str(fa)))
    assert list(fastx.iter_seqs(str(fq), "fq")) == list(jfastx.iter_seqs(str(fq), "fq"))
    entries = fastx.read_input_csv(str(csv))
    assert entries == jfastx.read_input_csv(str(csv))
    for ambig in (False, True):
        got = list(fastx.stream_encoded(entries, ambig=ambig))
        want = list(jfastx.stream_encoded(entries, ambig=ambig))
        assert [g for _, g in got] == [g for _, g in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.csv"
    bad.write_text("r.fa,-1,fa\n")
    with pytest.raises(ValueError, match="negative"):
        fastx.read_input_csv(str(bad))
    with pytest.raises(ValueError, match="file type"):
        list(fastx.iter_seqs(str(fa), "bam"))


@pytest.mark.parametrize("alphabet,lag", [("dna", 5), ("prot", 3)])
def test_alphabet_codecs_match_bear_tpu(alphabet, lag):
    rng = np.random.default_rng(4)
    letters = alphabets.residues(alphabet)
    kmers = np.array(["[" * k + _rand_seq(rng, lag - k, letters)
                      for k in rng.integers(0, lag + 1, size=50)])
    codes = alphabets.encode_kmers(kmers, alphabet)
    np.testing.assert_array_equal(codes, jalpha.encode_kmers(kmers, alphabet))
    np.testing.assert_array_equal(alphabets.decode_kmers(codes, alphabet), kmers)
    joined = "".join(kmers)
    codes_s = alphabets.encode_string(joined, alphabet)
    assert codes_s.dtype == np.int8 and codes_s.flags.writeable
    np.testing.assert_array_equal(codes_s, jalpha.encode_string(joined, alphabet))
    for bad in ("!", "\0"):  # the first bad letter is named, as bear_tpu names it
        with pytest.raises(ValueError) as want:
            jalpha.encode_string(joined + bad + "N!", alphabet)
        with pytest.raises(ValueError, match="outside") as got:
            alphabets.encode_string(joined + bad + "N!", alphabet)
        assert str(got.value) == str(want.value)
    with pytest.raises(UnicodeEncodeError):
        alphabets.encode_string(joined + "\xe9", alphabet)
    A1 = alphabets.alphabet_size(alphabet) + 1
    np.testing.assert_array_equal(
        alphabets.one_hot(torch.from_numpy(codes), A1, torch.float64).numpy(),
        np.asarray(jalpha.one_hot(codes, A1, np.float64)))
    with pytest.raises(ValueError, match="same length"):
        alphabets.encode_kmers(np.array([kmers[0], kmers[0][:-1]]), alphabet)
    with pytest.raises(ValueError, match="outside"):
        alphabets.encode_string("AC!", alphabet)
