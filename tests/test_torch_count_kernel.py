"""The fused counting entry (bear_tpu_torch/counting/count_chunk.py) on the
CPU.

- ``count_chunk_update`` on CPU tensors (its plain version) against
  bear_tpu's ``TransitionCounter`` with ``method="scatter"`` and with
  ``method="sorted"`` (the Pallas kernel in interpret mode), on the chunk
  cases of tests/test_torch_counting.py: tables bit-equal.
- A numpy model of csrc/count_chunk.cu's thread mapping (flat tiles with the
  code halo, runs of 8 positions, the rolling base-A code with its reset at
  row starts, the lag table the wrapper hands the kernel): its keys must
  equal ``chunk_keys`` exactly. The kernel itself runs only on the card
  (tests/test_torch_cuda.py, chip_smoke.py); this is the CPU check of its
  arithmetic.
- meta packing round trips, the wrapper's refusals, the build digest.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.counting import engine as jengine
from bear_tpu_torch import _build
from bear_tpu_torch.counting import count_chunk as cc
from bear_tpu_torch.counting import engine
from test_torch_counting import CASES, _case, interpret  # noqa: F401 (fixture)

torch.set_num_threads(2)
THREADS = cc.TILE // cc.RUN
CODE_BYTES = 2112  # kCodeBytes of csrc/count_chunk.cu
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


def _model_keys(codes, meta, lags, n_groups, A, tile):
    """Keys of one launch as csrc/count_chunk.cu forms them, laid out as
    chunk_keys lays them out ([n_lags * B * (L+1)], lag-major, the table
    size where nothing is counted). Asserts the kernel's staging bounds:
    every byte a thread reads was staged, and a tile spans <= MAX_ROWS."""
    B, L = codes.shape
    P, n_bytes = L + 1, B * L
    n_pos = B * P
    lt = cc.lag_table(tuple(sorted(lags)), n_groups, A)
    M, top = lt.max_lag, lt.top_power
    lag_rows = [lt.lag[k] for k in range(lt.n_lags)]
    _, n_table = cc.lag_offsets(lags, n_groups, A)
    flat = codes.reshape(-1).astype(np.int64)
    out = np.full((lt.n_lags, n_pos), n_table, np.int64)
    u32 = 0xFFFFFFFF
    for f0 in range(0, n_pos, tile):
        # Staging: one 16-aligned byte range with the max_lag halo in front.
        f1 = min(f0 + tile, n_pos)
        b0 = f0 // P
        lo = (b0 * L + (f0 - b0 * P) - M) & ~15
        b1 = (f1 - 1) // P
        hi = min(b1 * L + (f1 - 1 - b1 * P) + 1, n_bytes)
        n16 = (hi - lo + 15) >> 4
        assert n16 * 16 <= CODE_BYTES and b1 - b0 + 1 <= cc.MAX_ROWS
        smem = np.zeros(n16 * 16, np.int64)
        for i in range(n16):
            c = lo + 16 * i
            if 0 <= c < n_bytes:
                got = min(16, n_bytes - c)
                smem[16 * i: 16 * i + got] = flat[c: c + got]
        rows_meta = meta[b0: b1 + 1].astype(np.int64)

        # Threads, vectorised: each takes RUN consecutive positions.
        fs = f0 + np.arange(THREADS) * cc.RUN
        act = fs < f1
        b = np.where(act, fs // P, b0)
        j = np.where(act, fs - b * P, 0)
        base = b * L - lo

        def digit(x, live):
            use = live & (x >= 0)
            idx = base + x
            assert ((idx >= 0) & (idx < smem.size) & (x < L))[use].all()
            return np.where(use, smem[np.clip(idx, 0, smem.size - 1)], 0)

        code = np.zeros(THREADS, np.int64)
        for i in range(M, 0, -1):
            code = (code * A + digit(j - i, act)) & u32
        for r in range(cc.RUN):
            on = act & (fs + r < f1)
            new_row = on & (j == L + 1)
            b = np.where(new_row, b + 1, b)
            j = np.where(new_row, 0, j)
            code = np.where(new_row, 0, code)
            base = np.where(new_row, base + L, base)
            m = rows_meta[np.clip(b - b0, 0, len(rows_meta) - 1)]
            length, skip, group, flags = m.T
            live = on & (j >= skip) & ((j < length) | ((j == length) & (flags & 1 != 0)))
            nxt = np.where(j < length, np.where(j < L, digit(j, live & (j < L)), 0), A)
            for k, lg in enumerate(lag_rows):
                ok = live & ((flags & 2 != 0) | (j >= lg.lag))
                c = code if lg.lag == M else code % lg.modulus
                pad = np.asarray(lg.pad)[np.maximum(0, lg.lag - j)]
                key = (lg.offset + ((group * lg.rows + pad + c) & u32) * (A + 1) + nxt) & u32
                key = np.where(key >= 1 << 31, key - (1 << 32), key)  # as int32
                ok &= (key >= 0) & (key < n_table)
                out[k, (fs + r)[ok]] = key[ok]
            roll = on & (j < L)
            nxt_digit = digit(j, roll)
            old = digit(j - M, roll & (j >= M))
            code = np.where(roll, (nxt_digit + A * ((code - old * top) & u32)) & u32, code)
            j = np.where(on, j + 1, j)
    return out.reshape(-1)


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


@pytest.mark.parametrize("tile", ["kernel", 64])
@pytest.mark.parametrize("case", CASES + ["row_longer_than_tile", "main_path_shape"])
def test_kernel_model_keys_equal_chunk_keys(case, tile):
    lags, G, reverse, alphabet, chunks = _model_case(case)
    A = 20 if alphabet == "prot" else 4
    _, total = cc.lag_offsets(lags, G, A)
    n_keys = 0
    for codes, meta in _kernel_inputs(chunks, reverse):
        t = cc.tile_positions(codes.shape[1]) if tile == "kernel" else tile
        got = _model_keys(codes, meta, lags, G, A, t)
        m = torch.from_numpy(meta)
        lengths, skip, stopped, groups, fresh = cc.unpack_meta(m)
        want = cc.chunk_keys(torch.from_numpy(codes), lengths, skip, stopped, groups,
                             tuple(sorted(lags)), G, A, sentinel=total, fresh=fresh)
        np.testing.assert_array_equal(got, want.numpy())
        n_keys += int((got < total).sum())
    assert n_keys > 0


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
    assert (lt.n_lags, lt.max_lag, lt.A, lt.top_power) == (2, 5, 4, 4**4)
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
