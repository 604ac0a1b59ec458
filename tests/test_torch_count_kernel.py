"""The fused counting entry (bear_tpu_torch/counting/count_chunk.py) on the
CPU.

- ``count_chunk_update`` on CPU tensors (its plain version) against
  bear_tpu's ``TransitionCounter`` with ``method="scatter"`` and with
  ``method="sorted"`` (the Pallas kernel in interpret mode), on the chunk
  cases of tests/test_torch_counting.py: tables bit-equal.
- A numpy model of csrc/count_chunk.cu's work decomposition (flat tiles with
  the code halo, lag groups over runs of positions, the rolling base-A code
  with its reset at row starts, the per-lag keying in 32-bit arithmetic,
  the lag table the wrapper hands the kernel) at the launch shape
  ``launch_shape`` picks for a 132-SM H100 and at forced shapes: its keys
  must equal ``chunk_keys`` exactly, on the chunk cases, on summarize's
  1,024 x 192 chunk over lags 1..13, and in the row-range form in every
  pass of a MultiPassTransitionCounter layout (DNA and protein). The kernel
  itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py);
  this is the CPU check of its arithmetic. ``launch_shape`` fills 132 SMs
  with 4 blocks each at that chunk and keeps the main path's shape.
- meta packing round trips, the wrapper's refusals, the build digest.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.counting import engine as jengine
from bear_tpu_torch import _build
from bear_tpu_torch.counting import count_chunk as cc
from bear_tpu_torch.counting import engine, fastx
from bear_tpu_torch.counting.multipass import MultiPassTransitionCounter
from test_torch_counting import CASES, _case, interpret  # noqa: F401 (fixture)

torch.set_num_threads(2)
CODE_BYTES = 2112  # kCodeBytes of csrc/count_chunk.cu
H100_SMS = 132
LAG_MAIN = chip_smoke.LAG


def _kernel_inputs(chunks, reverse):
    """(codes, meta) numpy pairs of every count_chunk launch of the chunks."""
    for c in chunks:
        for codes, *rows in engine.chunk_passes(c, reverse):
            yield np.ascontiguousarray(codes, np.int8), cc.pack_meta(*rows)


def _split(table, lags, n_groups, A):
    offsets, _ = cc.lag_offsets(lags, n_groups, A)
    return {l: table[offsets[l]: offsets[l] + n_groups * cc.table_rows(l, A) * (A + 1)]
            .reshape(n_groups, cc.table_rows(l, A), A + 1) for l in lags}


@pytest.mark.parametrize("method", ["scatter", "sorted"])
@pytest.mark.parametrize("case", CASES)
def test_count_chunk_bit_equal_to_bear_tpu(interpret, case, method):
    lags, G, reverse, alphabet, chunks = _case(case)
    A = 20 if alphabet == "prot" else 4
    ref = jengine.TransitionCounter(lags=lags, n_groups=G, reverse=reverse,
                                    method=method, alphabet=alphabet)
    for c in chunks:
        ref.add_chunk(c)
    _, total = cc.lag_offsets(lags, G, A)
    table = torch.zeros(total, dtype=torch.int32)
    before = cc.count_chunk_update.launches
    for codes, meta in _kernel_inputs(chunks, reverse):
        out = cc.count_chunk_update(table, torch.from_numpy(codes),
                                    torch.from_numpy(meta), lags, G, A)
        assert out is table  # updated in place
    assert cc.count_chunk_update.launches == before  # CPU: the plain version
    got = _split(table.numpy().astype(np.int64), lags, G, A)
    for l in lags:
        np.testing.assert_array_equal(got[l], ref.tables[l])


# --- numpy model of the kernel's thread mapping ------------------------------


def _model_keys(codes, meta, lags, n_groups, A, shape, shard=None):
    """Keys of one launch as csrc/count_chunk.cu forms them, laid out as
    chunk_keys lays them out ([n_lags * B * (L+1)], lag-major, the table
    size where nothing is counted). Every (tile, thread) pair runs at once,
    as numpy vectors: a thread's slice of the block picks its lag group, its
    place in the slice its run of ``shape.run`` positions; it walks the run
    (the rolling code, reset at row starts), then keys each lag of its group
    over the run in the kernel's 32-bit arithmetic (the row-range form's
    local row compared first). Asserts the kernel's staging bounds (every
    byte a thread reads was staged, a tile spans <= MAX_ROWS rows), that the
    persistent grid walks every tile once, and that no (position, lag) is
    keyed twice."""
    B, L = codes.shape
    P, n_bytes = L + 1, B * L
    n_pos = B * P
    lags = tuple(sorted(lags))
    if shard is None:
        lt = cc.lag_table(lags, n_groups, A)
        idx, (_, n_table) = 0, cc.lag_offsets(lags, n_groups, A)
    else:
        idx, per_lag = shard
        lt = cc.lag_table(lags, n_groups, A, tuple(sorted(per_lag.items())))
        n_table = cc.shard_size(per_lag, n_groups, A)
    M, top = lt.max_lag, lt.top_power
    tile, run, groups, blocks = shape
    assert 1 <= tile <= cc.THREADS // groups * run and tile <= (cc.MAX_ROWS - 1) * P
    assert groups in (1, 2, 4, 8) and groups <= lt.n_lags and 1 <= run <= cc.RUN
    out = np.full((lt.n_lags, n_pos), n_table, np.int64)
    if n_pos == 0:
        return out.reshape(-1)
    u32 = 0xFFFFFFFF
    n_tiles = -(-n_pos // tile)
    walked = np.concatenate([np.arange(b, n_tiles, blocks) for b in range(blocks)])
    assert np.array_equal(np.sort(walked), np.arange(n_tiles))

    # Staging: per tile one 16-aligned byte range with the max_lag halo.
    f0 = np.arange(n_tiles) * tile
    f1 = np.minimum(f0 + tile, n_pos)
    b0 = f0 // P
    lo = (b0 * L + (f0 - b0 * P) - M) & ~15
    b1 = (f1 - 1) // P
    hi = np.minimum(b1 * L + (f1 - 1 - b1 * P) + 1, n_bytes)
    staged = ((hi - lo + 15) >> 4) * 16
    assert (staged <= CODE_BYTES).all() and (b1 - b0 + 1 <= cc.MAX_ROWS).all()

    # Threads: block slice -> lag group, place in the slice -> run.
    tid = np.tile(np.arange(cc.THREADS), n_tiles)
    t = np.repeat(np.arange(n_tiles), cc.THREADS)
    f0, f1, b0, b1, lo, staged = (a[t] for a in (f0, f1, b0, b1, lo, staged))
    slice_ = cc.THREADS // groups
    g = tid // slice_
    fs = f0 + (tid - g * slice_) * run
    act = fs < f1
    n_run = np.clip(f1 - fs, 0, run)
    b = np.where(act, fs // P, b0)
    j = np.where(act, fs - b * P, 0)
    flat = np.append(codes.reshape(-1).astype(np.int64), 0)

    def digit(x, use):
        use = use & (x >= 0)
        at = b * L + x  # the byte codes[b, x]: staged, and inside the row
        assert ((at >= lo) & (at < lo + staged) & (x < L))[use].all()
        return np.where(use, flat[np.clip(at, 0, n_bytes)], 0)

    code = np.zeros_like(fs)
    for i in range(M, 0, -1):
        code = (code * A + digit(j - i, act)) & u32
    walk = []  # per run position: live, the largest lag counted, min(j, 31), code, next, group
    for r in range(run):
        on = act & (r < n_run)
        new_row = on & (j == L + 1)
        b = np.where(new_row, b + 1, b)
        j = np.where(new_row, 0, j)
        code = np.where(new_row, 0, code)
        assert (b <= b1)[on].all()
        length, skip, group, flags = meta[np.clip(b, 0, B - 1)].astype(np.int64).T
        live = on & (j >= skip) & ((j < length) | ((j == length) & (flags & 1 != 0)))
        jc = np.minimum(j, 31)
        lim = np.where(flags & 2 != 0, 31, jc)
        nxt = np.where(j < length, np.where(j < L, digit(j, live & (j < L)), 0), A)
        walk.append((live, lim, jc, code, nxt, group, fs + r))
        roll = on & (j < L)
        old = digit(j - M, roll & (j >= M))
        code = np.where(roll, (digit(j, roll) + A * ((code - old * top) & u32)) & u32, code)
        j = np.where(on, j + 1, j)

    keyed = np.zeros((lt.n_lags, n_pos), np.int64)
    for k in range(lt.n_lags):
        lg = lt.lag[k]
        mine = g == k % groups
        use_mod = lt.a_shift == 0 and lg.lag != M
        keep = u32 if lg.lag == M else lg.modulus - 1
        first_row = idx * lg.stride
        pad = np.asarray(lg.pad, np.int64)
        for live, lim, jc, cd, nxt, group, pos in walk:
            ok = mine & live & (lg.lag <= lim)
            c = cd % lg.modulus if use_mod else cd & keep
            rloc = (c + np.where(jc >= lg.lag, pad[0], pad[np.clip(lg.lag - jc, 0, lg.lag)])
                    - first_row) & u32
            ok &= rloc < lg.local_rows
            key = lg.offset + (group * lg.local_rows + rloc) * (A + 1) + nxt
            ok &= (key >= 0) & (key < n_table)
            np.add.at(keyed[k], pos[ok], 1)
            out[k, pos[ok]] = key[ok]
    assert keyed.max() <= 1
    return out.reshape(-1)


def _want_keys(codes, meta, lags, n_groups, A, shard=None):
    m = torch.from_numpy(meta)
    lengths, skip, stopped, groups, fresh = cc.unpack_meta(m)
    if shard is None:
        _, total = cc.lag_offsets(lags, n_groups, A)
    else:
        total = cc.shard_size(shard[1], n_groups, A)
    return cc.chunk_keys(torch.from_numpy(codes), lengths, skip, stopped, groups,
                         tuple(sorted(lags)), n_groups, A, sentinel=total, fresh=fresh,
                         shard=shard).numpy(), total


def _shape(codes, lags, kind):
    """The launch shape the wrapper picks on a 132-SM H100 ("kernel"), or a
    forced one: runs of 8 and one group ("runs_of_8", the main path's),
    64-position tiles of runs of 2 in two groups (64), one position and
    every group (8 at most) per thread ("split"), over 3 blocks."""
    B, L = codes.shape
    n = len(set(lags))
    most = min(cc.MAX_GROUPS, 1 << (n.bit_length() - 1))
    if kind == "kernel":
        return cc.launch_shape(B, L, n, H100_SMS)
    run, groups = {"runs_of_8": (cc.RUN, 1), 64: (2, min(2, most)), "split": (1, most)}[kind]
    tile = 64 if kind == 64 else cc.tile_positions(L, run, groups)
    return cc.LaunchShape(min(tile, (cc.MAX_ROWS - 1) * (L + 1)), run, groups, 3)


def _model_case(name):
    if name == "main_path_shape":
        # Full 150 bp rows at lag 13, as chip_smoke.py counts them: the code
        # at j == L is nonzero, so a run crossing a row start must reset it.
        reads, groups = chip_smoke.make_reads(genome_mb=0.002, coverage=4, seed=5)
        return (LAG_MAIN,), 2, False, "dna", list(chip_smoke.read_chunks(reads, groups, rows=24))
    if name != "row_longer_than_tile":
        return _case(name)
    rng = np.random.default_rng(99)
    reads = [(rng.integers(0, 4, size=n).astype(np.int8), i % 2)
             for i, n in enumerate([5000, 3, 0, 2100, 17])]
    return (2, 7), 2, True, "dna", list(engine.chunk_reads(iter(reads), 7, batch_size=4))


@pytest.mark.parametrize("tile", ["kernel", 64, "runs_of_8", "split"])
@pytest.mark.parametrize("case", CASES + ["row_longer_than_tile", "main_path_shape"])
def test_kernel_model_keys_equal_chunk_keys(case, tile):
    lags, G, reverse, alphabet, chunks = _model_case(case)
    A = 20 if alphabet == "prot" else 4
    n_keys = 0
    for codes, meta in _kernel_inputs(chunks, reverse):
        got = _model_keys(codes, meta, lags, G, A, _shape(codes, lags, tile))
        want, total = _want_keys(codes, meta, lags, G, A)
        np.testing.assert_array_equal(got, want)
        n_keys += int((got < total).sum())
    assert n_keys > 0


def _summarize_chunk(lag, rows=1024):
    """The first chunk summarize makes of a FASTQ file of chip_smoke's reads
    (chunks_from_packed at max_lag ``lag``: 1,024 reads of 150 bp in rows
    of 192), at a small genome."""
    reads, groups = chip_smoke.make_reads(genome_mb=0.05, coverage=4, seed=3)
    reads = reads[groups == 0][:rows]
    offsets = np.arange(len(reads) + 1, dtype=np.int64) * reads.shape[1]
    chunk = next(iter(engine.chunks_from_packed(reads.reshape(-1), offsets, 0, lag)))
    meta = cc.pack_meta(chunk.lengths, chunk.skip, chunk.stopped, chunk.groups, chunk.fresh)
    return np.ascontiguousarray(chunk.codes, np.int8), meta


@pytest.mark.parametrize("tile", ["kernel", "runs_of_8"])
def test_kernel_model_summarize_chunk(tile):
    # Summarize's chunk over lags 1..13 in one launch: 1,024 x 192 codes.
    lags = tuple(range(1, LAG_MAIN + 1))
    codes, meta = _summarize_chunk(LAG_MAIN)
    assert codes.shape == (1024, 192)
    shape = _shape(codes, lags, tile)
    assert (shape.run, shape.groups) == ((4, 4) if tile == "kernel" else (cc.RUN, 1))
    got = _model_keys(codes, meta, lags, 2, 4, shape)
    want, total = _want_keys(codes, meta, lags, 2, 4)
    np.testing.assert_array_equal(got, want)
    assert int((got < total).sum()) == len(lags) * 1024 * 151


def _row_range_case(alphabet):
    """(lags, passes, [(codes, meta)]) of a row-range model case: DNA at
    lags 1..15 over 9 passes (phase 4g's layout) on ragged reads, some
    ambiguity pieces (not fresh) among them; protein at lags 1..4 over 4."""
    rng = np.random.default_rng(15 if alphabet == "dna" else 4)
    if alphabet == "dna":
        lags, passes = tuple(range(1, 16)), 9
        reads = [(rng.choice(list("ACGTN"), size=int(rng.integers(0, 90))), i % 2)
                 for i in range(60)]
        pieces = list(engine.split_ambiguous(
            [(fastx.encode_seq("".join(s), ambig=True), g) for s, g in reads]))
        chunks = list(engine.chunk_reads(iter(pieces), 15, batch_size=32))
    else:
        lags, passes = (1, 2, 3, 4), 4
        reads = [(rng.integers(0, 20, size=int(rng.integers(0, 40))).astype(np.int8), i % 2)
                 for i in range(40)]
        chunks = list(engine.chunk_reads(iter(reads), 4, batch_size=16))
    return lags, passes, list(_kernel_inputs(chunks, False))


@pytest.mark.parametrize("tile", ["kernel", "runs_of_8", "split"])
@pytest.mark.parametrize("alphabet", ["dna", "prot"])
def test_kernel_model_row_range_every_pass(alphabet, tile):
    lags, passes, inputs = _row_range_case(alphabet)
    A = 4 if alphabet == "dna" else 20
    layout = MultiPassTransitionCounter(lags, n_groups=2, passes=passes, alphabet=alphabet,
                                        device="cpu")
    assert (layout.A, layout.passes) == (A, passes)
    per_pass = []
    for d in range(passes):
        shard = (d, layout._per_lag)
        n = 0
        for codes, meta in inputs:
            got = _model_keys(codes, meta, lags, 2, A, _shape(codes, lags, tile), shard)
            want, total = _want_keys(codes, meta, lags, 2, A, shard)
            np.testing.assert_array_equal(got, want)
            n += int((got < total).sum())
        per_pass.append(n)
    # Every pass keeps some keys, and each transition lands in exactly one.
    assert all(n > 0 for n in per_pass)
    assert sum(per_pass) == sum(_counted(codes.shape[1], meta, lags) for codes, meta in inputs)


def _counted(L, meta, lags):
    """Transitions a launch counts over ``lags``: the mask rules on the meta."""
    length, skip, _, flags = meta.astype(np.int64).T[:, :, None]
    j = np.arange(L + 1)[None, :]
    live = (j >= skip) & ((j < length) | ((j == length) & (flags & 1 != 0)))
    return sum(int((live & ((flags & 2 != 0) | (j >= l))).sum()) for l in lags)


def test_launch_shape_fills_the_card_and_keeps_the_main_path():
    # (L)'s and (G)'s chunk, 1,024 x 192 over lags 1..15 / 1..13 / 1..14:
    # at least 4 blocks of 8 warps on each of 132 SMs.
    for n_lags in (13, 14, 15):
        shape = cc.launch_shape(1024, 192, n_lags, H100_SMS)
        assert shape == cc.LaunchShape(256, 4, 4, 4 * H100_SMS)
        n_tiles = -(-1024 * 193 // shape.tile)
        assert n_tiles >= shape.blocks >= 4 * H100_SMS
    # The main path's 16,384 x 150 one-lag chunk keeps runs of 8 in one
    # group, tiles of 2,048 (1,208 of them) over the same 528 blocks.
    assert cc.launch_shape(chip_smoke.CHUNK_ROWS, 150, 1, H100_SMS) == \
        cc.LaunchShape(cc.TILE, cc.RUN, 1, 4 * H100_SMS)
    # Every shape is one the launcher takes.
    rng = np.random.default_rng(0)
    for _ in range(500):
        B, L = int(rng.integers(1, 20_000)), int(rng.integers(0, 400))
        n_lags, sms = int(rng.integers(1, 16)), int(rng.integers(1, 200))
        tile, run, groups, blocks = cc.launch_shape(B, L, n_lags, sms)
        assert run in (1, 2, 4, 8) and groups in (1, 2, 4, 8) and groups <= n_lags
        assert 1 <= tile <= cc.THREADS // groups * run and tile <= (cc.MAX_ROWS - 1) * (L + 1)
        assert 1 <= blocks <= max(1, min(-(-B * (L + 1) // tile), cc.BLOCKS_PER_SM * sms))


def test_tile_positions_keep_rows_and_bytes_in_bounds():
    for L in [0, 1, 7, 16, 64, 150, 151, 5000, 65_536 + 15]:
        t = cc.tile_positions(L)
        P = L + 1
        assert 1 <= t <= cc.TILE
        # Most rows a tile of t positions spans, from any start.
        assert (t - 1) // P + 2 <= cc.MAX_ROWS
        assert t + cc.MAX_LAG + 30 <= CODE_BYTES


# --- meta packing -------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_meta_pack_unpack_round_trip(case):
    lags, G, reverse, alphabet, chunks = _case(case)
    for c in chunks:
        for codes, lengths, skip, stopped, groups, fresh in engine.chunk_passes(c, reverse):
            meta = cc.pack_meta(lengths, skip, stopped, groups, fresh)
            assert meta.dtype == np.int32 and meta.shape == (len(lengths), 4)
            got = [t.numpy() for t in cc.unpack_meta(torch.from_numpy(meta))]
            want_fresh = np.ones(len(lengths), bool) if fresh is None else fresh
            for g, w in zip(got, [lengths, skip, stopped, groups, want_fresh]):
                np.testing.assert_array_equal(g, np.asarray(w))
            # And back: the unpacked columns pack into the same meta, also
            # into a caller's buffer (the pinned staging path).
            out = np.full_like(meta, -7)
            assert cc.pack_meta(*got, out=out) is out
            np.testing.assert_array_equal(out, meta)


def test_meta_round_trip_random():
    rng = np.random.default_rng(8)
    meta = np.stack([rng.integers(0, 300, 500), rng.integers(0, 20, 500),
                     rng.integers(0, 5, 500), rng.integers(0, 4, 500)], 1).astype(np.int32)
    cols = cc.unpack_meta(torch.from_numpy(meta))
    assert [t.dtype for t in cols] == [torch.int32, torch.int32, torch.bool,
                                      torch.int32, torch.bool]
    np.testing.assert_array_equal(cc.pack_meta(*[t.numpy() for t in cols]), meta)


# --- the wrapper ---------------------------------------------------------------


def _args(bad):
    lags, G, A = (1, 3), 2, 4
    _, total = cc.lag_offsets(lags, G, A)
    table = torch.zeros(total, dtype=torch.int32)
    codes = torch.zeros((4, 16), dtype=torch.int8)
    meta = torch.from_numpy(cc.pack_meta(np.full(4, 16), np.zeros(4), np.ones(4, bool),
                                         np.zeros(4)))
    if bad == "table_int64":
        table = table.long()
    elif bad == "codes_int32":
        codes = codes.int()
    elif bad == "meta_int64":
        meta = meta.long()
    elif bad == "codes_1d":
        codes = codes.reshape(-1)
    elif bad == "meta_rows":
        meta = meta[:3]
    elif bad == "meta_cols":
        meta = meta[:, :3].contiguous()
    elif bad == "codes_strided":
        codes = torch.zeros((4, 32), dtype=torch.int8)[:, ::2]
    elif bad == "table_2d":
        table = table.reshape(2, -1)
    elif bad == "device_mismatch":
        meta = meta.to("meta")
    elif bad == "table_size":
        table = torch.zeros(total + 1, dtype=torch.int32)
    elif bad == "lag_too_large":
        lags = (1, cc.MAX_LAG + 1)
    elif bad == "lag_zero":
        lags = (0, 3)
    elif bad == "no_lags":
        lags = ()
    elif bad == "codes_beyond_int32":
        A, lags = 20, (8,)
    return table, codes, meta, lags, G, A


BAD = ["table_int64", "codes_int32", "meta_int64", "codes_1d", "meta_rows",
       "meta_cols", "codes_strided", "table_2d", "device_mismatch", "table_size",
       "lag_too_large", "lag_zero", "no_lags", "codes_beyond_int32"]


@pytest.mark.parametrize("bad", BAD)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table, codes, meta, lags, G, A = _args(bad)
    before = table.clone()
    with pytest.raises((TypeError, ValueError)):
        cc.count_chunk_update(table, codes, meta, lags, G, A)
    assert torch.equal(table, before)


def test_cpu_call_launches_nothing_and_counts():
    table, codes, meta, lags, G, A = _args(None)
    before = cc.count_chunk_update.launches
    cc.count_chunk_update(table, codes, meta, lags, G, A)
    assert cc.count_chunk_update.launches == before
    # 4 stopped rows of 16 residues: 17 transitions per row and lag.
    assert int(table.sum()) == 4 * 17 * len(lags)


def test_lag_table_mirrors_the_layout():
    lt = cc.lag_table((2, 5), 3, 4)
    offsets, _ = cc.lag_offsets((2, 5), 3, 4)
    assert (lt.n_lags, lt.max_lag, lt.A, lt.top_power, lt.a_shift) == (2, 5, 4, 4**4, 2)
    assert cc.lag_table((2,), 1, 20).a_shift == 0  # protein keeps the remainder
    for k, l in enumerate((2, 5)):
        assert (lt.lag[k].lag, lt.lag[k].offset, lt.lag[k].rows, lt.lag[k].modulus) == \
            (l, offsets[l], cc.table_rows(l, 4), 4**l)
        assert list(lt.lag[k].pad[: l + 1]) == [cc.pad_offset(l, n, 4) for n in range(l + 1)]


def test_build_digest_covers_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)
