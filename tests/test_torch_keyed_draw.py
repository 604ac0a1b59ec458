"""The keyed-draw kernel's module (bear_tpu_torch.ops.keyed_draw) on the CPU.

The CUDA kernel runs only on a card (tests/test_torch_cuda.py holds it
against the plain version there). Here:

- a numpy model of the kernel's uint32 arithmetic (Philox4x32-10 with each
  64-bit product split into its high and low words, fold_in of int64 rows,
  the stream layout) equals the port's Philox, fold_in and stream_words bit
  for bit;
- a scalar model of the kernel's control flow (sample tiles of the launch
  shape with the element's constants hoisted, each quad's blocks drawn
  together, retries deferred to the end of a sub-tile of samples, from kept
  or new blocks, the logsumexp summed in category order, NaN for an invalid
  index) equals the plain version:
  float64 at rtol 1e-12, float32 at 2e-6 of the operands' scale, with no
  lane beyond, and reaches every path;
- the launch shape covers every (sample, element) once within the grid's
  limits; the bound's count by execution unit adds up;
- the plain version equals the composition the port ran before the kernel
  (fold_in, log_dirichlet_draw_keyed, the pick) bit for bit;
- against bear_tpu's _sampled_logp_picked by distribution (KS, moments):
  the two draw from different generators (Philox, threefry);
- CPU tensors run the plain version and launch nothing; other devices raise.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st

import chip_smoke
from bear_tpu.inference import serving as jserving
from bear_tpu.ops import loggamma as jloggamma
from bear_tpu_torch.inference import serving
from bear_tpu_torch.ops import keyed_draw
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.ops import loggamma
from bear_tpu_torch.ops.keyed_draw import keyed_draw_full, keyed_draw_picked, keyed_draw_plain
from test_torch_loggamma import PHILOX_KAT

torch.set_num_threads(2)
M32 = np.uint64(0xFFFFFFFF)
DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64)}


# -- the kernel's uint32 arithmetic, in numpy ------------------------------

def np_philox(counter, key):
    """Philox4x32-10 as the kernel computes it: uint32 words (held in
    uint64 arrays), each product's high word (__umulhi) and low word."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) & M32 for c in counter)
    k0, k1 = (np.asarray(k, np.uint64) & M32 for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = c0 * np.uint64(0xD2511F53)
        p1 = c2 * np.uint64(0xCD9E8D57)
        hi0, lo0 = p0 >> np.uint64(32), p0 & M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def np_split(x):
    """int64 -> (low, high) uint32 words, as the kernel reads them."""
    u = np.asarray(x, np.int64).view(np.uint64)
    return u & M32, u >> np.uint64(32)


def np_fold_in(keys, rows):
    w = np_philox((*np_split(rows), 0, 0), np_split(keys))
    return (w[0] | (w[1] << np.uint64(32))).view(np.int64)


def np_word(keys, sid, j):
    """Word j of stream sid under int64 keys: lane j % 4 of the block with
    counter (0, 0, sid, j // 4)."""
    return np_philox((0, 0, sid, j // 4), np_split(keys))[j % 4]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_numpy_philox_known_answers(counter, key, want):
    assert [int(w) for w in np_philox(counter, key)] == want


def test_numpy_philox_equals_the_port_bit_for_bit():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint64)
    c = [np.concatenate([edge, rng.integers(0, 1 << 32, 2000, dtype=np.uint64)])
         for _ in range(4)]
    k = [np.concatenate([edge[::-1], rng.integers(0, 1 << 32, 2000, dtype=np.uint64)])
         for _ in range(2)]
    want = kr.philox4x32([torch.from_numpy(x.astype(np.int64)) for x in c],
                         [torch.from_numpy(x.astype(np.int64)) for x in k])
    for a, b in zip(np_philox(c, k), want):
        np.testing.assert_array_equal(a.astype(np.int64), b.numpy())


def test_numpy_fold_in_and_streams_equal_the_port_bit_for_bit():
    rng = np.random.default_rng(1)
    i64 = np.iinfo(np.int64)
    keys = np.concatenate([[0, -1, i64.min, i64.max, 1 << 32],
                           rng.integers(i64.min, i64.max, 500, dtype=np.int64)])
    rows = np.concatenate([[0, -1, (1 << 31) + 5, -(1 << 40), 0xFFFFFFFF],
                           rng.integers(-(1 << 45), 1 << 45, 500)]).astype(np.int64)
    folded = np_fold_in(keys, rows)
    np.testing.assert_array_equal(folded, kr.fold_in(torch.from_numpy(keys),
                                                     torch.from_numpy(rows)).numpy())
    for A1, F in ((5, 3), (21, 6), (5, 1)):
        streams = [(kr.NORMAL, loggamma._pairs(F * A1)), (kr.EXPONENTIAL, F * A1),
                   (kr.BOOST, A1)]
        got = kr.stream_words(torch.from_numpy(folded), 0, streams)
        for (sid, n), words in zip(streams, got):
            want = np.stack([np_word(folded, sid, j) for j in range(n)], -1)
            np.testing.assert_array_equal(want.astype(np.int64), words.numpy())


# -- the kernel's control flow, as a scalar model --------------------------

def sub_tile(A1, itemsize):
    """Samples whose rows wait for their retries together, as
    csrc/keyed_draw.cu's sub_tile: as many as 40,960 bytes hold for 128
    threads, 1..16."""
    return max(1, min(16, 40960 // (A1 * 128 * itemsize)))


def kernel_model(base, group, rows, conc, F, nxt, np_dtype, sms=132):
    """csrc/keyed_draw.cu's algorithm for every (s, e) in numpy scalars of
    np_dtype, in the tiles of its launch shape: per element and sample tile
    its constants once (safe, cc = 1/sqrt(9d), log d); per sub-tile of
    samples, first every draw's first proposals, a category quad at a time
    from that quad's NORMAL, EXPONENTIAL and BOOST blocks, drawn together
    (one theta for both normals of a pair), leaving rows and rejected
    (sample, category) items; then each item's retry (proposals 1..F-1,
    with F = 1 proposal 0 again, one a round), each from its draw's kept
    last-quad blocks or a newly drawn one, and the clamped last cube; then
    -inf for a zero
    concentration (never retried) and the logsumexp in category order; NaN
    for an invalid index. Returns ([S, E] picked or [S, E, A1] full,
    counts): categories by what decided them, "first", "later" (of which
    "later_kept": its words from a kept block), "fallback", "zero";
    elements "invalid"; "blocks" drawn."""
    T = np_dtype
    (S, G), (E, A1) = base.shape, conc.shape
    shape = keyed_draw.launch_shape(S, E, sms)
    sub = sub_tile(A1, np.dtype(T).itemsize)
    NQ = -(-A1 // 4)
    out = np.empty((S, E) if nxt is not None else (S, E, A1), T)
    paths = collections.Counter()

    def uniform(w):
        if T is np.float32:
            return (T(int(w) >> 9) + T(0.5)) * T(2.0**-23)
        return (T(int(w)) + T(0.5)) * T(2.0**-32)

    def box_muller(w1, w2):
        r = np.sqrt(T(-2.0) * np.log(uniform(w1)))
        theta = T(2.0 * math.pi) * uniform(w2)
        return r * np.cos(theta), r * np.sin(theta)

    def propose(x, log_u, d, cc):
        t = T(1) + cc * x
        v = t * t * t
        vs = v if v > 0 else T(1)
        lv = np.log(vs)
        return bool(v > 0 and log_u < T(0.5) * x * x + d - d * vs + d * lv), v, lv

    def block(key, sid, b):
        paths["blocks"] += 1
        return np_philox((0, 0, sid, b), np_split(key))

    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        for e in range(E):
            k = int(nxt[e]) if nxt is not None else 0
            if not (0 <= group[e] < G and 0 <= k < A1):
                out[:, e] = np.nan
                paths["invalid"] += 1
                continue
            for t0 in range(0, S, shape.tile):  # the element's constants, once a tile
                c = conc[e].astype(T)
                safe = np.where(c < T(1e-30), T(1e-30), c)
                d = safe + T(1.0 - 1.0 / 3.0)
                cc = T(1) / np.sqrt(T(9) * d)
                logd = np.log(d)
                t_end = min(S, t0 + shape.tile)
                for s0 in range(t0, t_end, sub):
                    lgs, items = {}, []
                    for s in range(s0, min(t_end, s0 + sub)):  # first proposals
                        key = np_fold_in(base[s, group[e]], rows[e])
                        lg, rejected = lgs.setdefault(s, np.empty(A1, T)), []
                        for q in range(NQ):
                            nb, eb, bb = (block(key, sid, q) for sid in (
                                kr.NORMAL, kr.EXPONENTIAL, kr.BOOST))
                            x = box_muller(nb[0], nb[1]) + box_muller(nb[2], nb[3])
                            for j in range(4):
                                a = 4 * q + j
                                if a >= A1:
                                    break
                                acc, _, lv = propose(x[j], np.log(uniform(eb[j])), d[a], cc[a])
                                bq = -np.log(uniform(bb[j])) / safe[a]
                                lg[a] = (logd[a] + lv) - bq if acc else bq
                                if not acc and c[a] > 0:
                                    rejected.append(a)
                                elif c[a] > 0:
                                    paths["first"] += 1
                        # with its key and the last quad's blocks, kept
                        items += [(s, a, key, nb, eb) for a in rejected]
                    for s, a, key, nb, eb in items:  # the retries, after the sub-tile
                        acc = False
                        for f in range(1 if F > 1 else 0, F):
                            n = f * A1 + a
                            kept = n >> 2 == NQ - 1
                            words, ewords = (nb, eb) if kept else (
                                block(key, kr.NORMAL, n >> 2), block(key, kr.EXPONENTIAL, n >> 2))
                            xc, xs = box_muller(words[n & 2], words[(n & 2) | 1])
                            acc, v, lv = propose(xs if n & 1 else xc,
                                                 np.log(uniform(ewords[n & 3])), d[a], cc[a])
                            if acc:
                                paths["later"] += 1
                                paths["later_kept"] += kept
                                break
                        if not acc:
                            lv = np.log(max(v, T(1e-3)))
                            paths["fallback"] += 1
                        lgs[s][a] = (logd[a] + lv) - lgs[s][a]
                    for s, lg in lgs.items():  # the rows, final
                        paths["zero"] += int((c <= 0).sum())
                        lg[c <= 0] = -np.inf
                        if nxt is None:
                            out[s, e] = lg
                            continue
                        m = lg.max()
                        m = T(0) if np.isinf(m) else m
                        total = T(0)
                        for a in range(A1):
                            total = total + np.exp(lg[a] - m)
                        out[s, e] = lg[k] - (np.log(total) + m)
    return out, paths


def model_vs_plain(inputs, F, mode, np_dtype, dtype):
    """The kernel model against the plain version on the valid elements
    (the plain version refuses an invalid index): (max error relative to
    the operands' scale, the model's counts)."""
    base, group, rows, conc, nxt = inputs
    G, A1 = base.shape[1], conc.shape[1]
    got, paths = kernel_model(base.numpy(), group.numpy(), rows.numpy(), conc.numpy(), F,
                              None if mode == "full" else nxt.numpy(), np_dtype)
    ok = (group >= 0) & (group < G) & ((nxt >= 0) & (nxt < A1) if mode == "picked" else True)
    base, group, rows, conc, nxt = base, group[ok], rows[ok], conc[ok], nxt[ok]
    got = got[:, ok.numpy()].astype(np.float64)
    want = keyed_draw_plain(base, group, rows, conc, F, None if mode == "full" else nxt)
    want = want.double().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    scale = np.abs(want) + 1
    if mode == "picked":
        scale += np.abs(torch.logsumexp(keyed_draw_plain(base, group, rows, conc, F), -1)
                        .double().numpy())
    fin = np.isfinite(want)
    return (np.abs(got[fin] - want[fin]) / scale[fin]).max(), paths


@pytest.mark.parametrize("A1", [5, 21])
@pytest.mark.parametrize("F", [1, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["picked", "full"])
def test_kernel_model_equals_the_plain_version(A1, F, dtype, mode):
    inputs = chip_smoke.keyed_draw_inputs(A1, dtype, "cpu", shape=(2, 30, 7), seed=A1 + F)
    rel, paths = model_vs_plain(inputs, F, mode, DTYPES[dtype][1], dtype)
    # the inputs reach every branch: a rejected first proposal is then
    # decided by a later one, or with F = 1 by the clamped cube
    assert paths["first"] > 0 and paths["later" if F > 1 else "fallback"] > 0, paths
    assert rel <= chip_smoke.KEYED_DRAW_RTOL[dtype], rel


def test_kernel_model_reaches_every_path():
    # 2 x 2,000 draws of 5 categories, two invalid elements: with F = 1 a
    # rejection is clamped at once; with F = 2 the retry accepts (from the
    # kept last quad's blocks for categories 0-2, a new block for 3-4) or
    # is clamped. Both against the plain version, float32 picked.
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float32", "cpu",
                                                                shape=(2, 2000, 7), seed=11)
    group[3], nxt[5] = -1, 5
    seen = collections.Counter()
    for F in (1, 2):
        rel, paths = model_vs_plain((base, group, rows, conc, nxt), F, "picked", np.float32,
                                    "float32")
        assert rel <= chip_smoke.KEYED_DRAW_RTOL["float32"], (F, rel)
        assert paths["invalid"] == 2 and paths["fallback"] > 0, (F, paths)
        # the first pass draws 3 x 2 stream blocks a draw; a retried
        # proposal at most a new normal and a new exponential block
        retried = paths["later"] + F * paths["fallback"]
        assert 6 * 2 * 1998 < paths["blocks"] <= 6 * 2 * 1998 + 2 * retried, paths
        seen.update(paths)
    assert all(seen[p] > 0 for p in ("first", "later", "later_kept", "fallback", "zero",
                                     "invalid")), seen
    assert seen["later_kept"] < seen["later"], seen


# -- the launch shape, as a pure function ------------------------------------

@pytest.mark.parametrize("S,E", [(41, 618_496), (41, 839_532), (41, 289_737), (1, 1024),
                                 (70_000, 3), (600_000, 2), (11, 100_000), (3, 1)])
def test_launch_shape_covers_every_draw_once(S, E):
    shape = keyed_draw.launch_shape(S, E, 132)
    assert 1 <= shape.grid_x < 2**31 and 1 <= shape.grid_y <= keyed_draw.MAX_GRID_Y
    # elements: block x takes THREADS of them
    assert (shape.grid_x - 1) * keyed_draw.THREADS < E <= shape.grid_x * keyed_draw.THREADS
    # samples: the kernel's loop, row y of blocks taking tiles y, y + grid_y, ...
    covered = np.zeros(S, np.int64)
    for y in range(shape.grid_y):
        t = y
        while t * shape.tile < S:
            covered[t * shape.tile:min(S, (t + 1) * shape.tile)] += 1
            t += shape.grid_y
    assert (covered == 1).all()
    blocks = shape.grid_x * -(-S // shape.tile)
    if S == 1:  # assembly's step: a sample a thread
        assert shape.tile == 1
    if S * E >= 32 * keyed_draw.BLOCKS_PER_SM * 132 * keyed_draw.THREADS:
        # enough draws to tile: a full tile, with the card still filled
        assert shape.tile > 1 and blocks >= keyed_draw.BLOCKS_PER_SM * 132
    if S <= keyed_draw.MAX_GRID_Y * keyed_draw.MAX_TILE:
        assert shape.tile <= keyed_draw.MAX_TILE
    assert keyed_draw.launch_shape(41, 618_496, 132) == (14, 4832, 3)


PTXAS_LOG = """ptxas info    : 296 bytes gmem
ptxas info    : Compiling entry function '_ZN4_Z17keyed_draw_kernelIdLi5ELb1EEEvPKll' for 'sm_90a'
ptxas info    : Function properties for _ZN4_Z17keyed_draw_kernelIdLi5ELb1EEEvPKll
    40 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN4_Z17keyed_draw_kernelIfLi0ELb0EEEvPKll' for 'sm_90a'
ptxas info    : Function properties for _ZN4_Z17keyed_draw_kernelIfLi0ELb0EEEvPKll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 77 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_kernel_and_not_its_callees():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == {
        "kernelIdLi5ELb1EE": {"stack": 40, "spill_stores": 8, "spill_loads": 12,
                              "registers": 128},
        "kernelIfLi0ELb0EE": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                              "registers": 77}}


# -- the bound, counted by execution unit ------------------------------------

@pytest.mark.parametrize("A1", [5, 21])
def test_sampler_work_and_bound_arithmetic(A1):
    R = chip_smoke.ROUTINE_SASS
    quads, pairs, lone = -(-A1 // 4), -(-A1 // 2), A1 % 2
    for dtype, t in (("float32", "f32"), ("float64", "f64")):
        w = chip_smoke.sampler_work_per_draw(A1, dtype)
        flops = 4 * pairs - lone + chip_smoke.FLOAT_OPS_PER_CATEGORY * A1 + 3 * A1 + 3
        want_imad = (1 + 3 * quads) * R["philox_block"]["imad"] + sum(
            R[f"{n}_{t}"].get("imad", 0) * k for n, k in (
                ("uniform", 2 * pairs + 2 * A1), ("log", pairs + 3 * A1 + 1), ("sqrt", pairs),
                ("sincos", pairs - lone), ("cos", lone), ("div", A1), ("exp", A1)))
        assert w["imad"] == want_imad
        want_issue = (2 * R["key_schedule"]["issue"] + (1 + 3 * quads) * R["philox_block"][
            "issue"] + sum(R[f"{n}_{t}"]["issue"] * k for n, k in (
                ("uniform", 2 * pairs + 2 * A1), ("log", pairs + 3 * A1 + 1), ("sqrt", pairs),
                ("sincos", pairs - lone), ("cos", lone), ("div", A1), ("exp", A1)))
            + flops + chip_smoke.INT_OPS_PER_CATEGORY * A1 + chip_smoke.OPS_PER_DRAW + A1 + 2)
        assert w["issue"] == want_issue
        if dtype == "float64":  # every float operation of the kernel's own on the fp64 unit
            assert w["fp64"] >= flops
        # the element's constants count once per element, not once per draw
        inputs = chip_smoke.keyed_draw_inputs(A1, dtype, "cpu", shape=(3, 100, 4))
        nb1, w1 = chip_smoke.keyed_draw_work(inputs[0][:1], *inputs[1:])
        nb3, w3 = chip_smoke.keyed_draw_work(*inputs)
        assert nb3 - nb1 == 2 * (100 * inputs[3].element_size() + 4 * 8)  # outputs, keys
        per_elem = chip_smoke.sampler_work_per_element(A1, dtype)
        for unit in w3:
            assert w3[unit] == 3 * 100 * w.get(unit, 0) + 100 * per_elem.get(unit, 0)
            assert w3[unit] - w1[unit] == 2 * 100 * w.get(unit, 0)
        full = chip_smoke.keyed_draw_work(*inputs, picked=False)
        assert full[0] == nb3 - 3 * 100 * inputs[3].element_size() - 100 * 4 + (
            3 * 100 * A1 * inputs[3].element_size())
        # the bound: the largest unit at its lanes a clock on 132 SMs at 1.98 GHz
        ms, by, unit_ms = chip_smoke.bound_of(nb3, w3, clock_hz=1.98e9, sms=132)
        assert unit_ms["bytes"] == pytest.approx(nb3 / 3.35e12 * 1e3)
        for unit, n in w3.items():
            lanes = chip_smoke.SM_LANES_PER_CLOCK[unit]
            assert unit_ms[unit] == pytest.approx(n / (lanes * 132 * 1.98e9) * 1e3)
        assert ms == max(unit_ms.values()) and unit_ms[by] == ms


# -- the plain version is the composition the port ran before ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_equals_the_earlier_composition(dtype):
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(
        5, str(dtype).removeprefix("torch."), "cpu", shape=(4, 300, 9))
    rows32 = rows.to(torch.int32)  # serving's rows are int32
    for r in (rows, rows32):
        keys = loggamma.fold_in_many(base[:, group], r)
        lg = loggamma.log_dirichlet_draw_keyed(keys, conc, n_iter=serving.SAMPLE_PROPOSALS)
        idx = nxt.long().expand(lg.shape[:-1])[..., None]
        picked = lg.gather(-1, idx)[..., 0] - torch.logsumexp(lg, dim=-1)
        got = keyed_draw_picked(base, group, r, conc, nxt, serving.SAMPLE_PROPOSALS)
        assert got.dtype == dtype and torch.equal(got, picked)
        assert torch.equal(got, serving._sampled_logp_picked(keys, conc, nxt))
        assert torch.equal(keyed_draw_full(base, group, r, conc, serving.SAMPLE_PROPOSALS), lg)
    # assembly's form: base keys [1, B], group b, four proposals
    seq_keys = kr.fold_in(kr.key(7), torch.arange(300))
    lg = loggamma.log_dirichlet_draw_keyed(kr.fold_in(seq_keys, rows), conc, n_iter=4)
    got = keyed_draw_full(seq_keys[None], torch.arange(300), rows, conc, 4)
    assert got.shape == (1, 300, 5) and torch.equal(got[0], lg)
    assert torch.isneginf(got[0][conc == 0]).all()
    assert torch.isneginf(keyed_draw_picked(base, group, rows, conc, nxt, 3)[:, conc[
        torch.arange(300), nxt.long()] == 0]).all()


def test_serving_draws_slice_on_the_cpu_only(monkeypatch):
    assert serving._draw_bytes(5, 4, device_type="cuda") == 0
    assert serving._draw_bytes(5, 4) == serving._draw_bytes(5, 4, device_type="cpu") > 0
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float64", "cpu",
                                                                shape=(3, 100, 4))
    server = serving.BearServer(np.zeros((serving.table_rows(1), 5)), 1, van=0.1,
                                dtype=torch.float64, device="cpu")
    whole = server._draw_picked(base, group, rows, nxt, conc)
    monkeypatch.setattr(serving, "SAMPLE_BUDGET_BYTES", 3 * serving._draw_bytes(5, 8) * 7)
    assert torch.equal(server._draw_picked(base, group, rows, nxt, conc), whole)  # 7 a slice
    assert torch.equal(whole, keyed_draw_plain(base, group, rows, conc, 3, nxt))


# -- against bear_tpu, by distribution -------------------------------------

CONCS = [[1e-4, 0.5, 2.0, 30.0, 3e-4], [0.05, 0.05, 1e4, 1.0, 1e-4],
         [1.0, 1.0, 1.0, 1.0, 0.0]]


@pytest.mark.parametrize("conc", CONCS)
def test_picked_against_bear_tpu_by_distribution(conc):
    N = 20_000
    conc = np.asarray(conc)
    A1 = len(conc)
    c = np.broadcast_to(conc, (N, A1)).copy()
    base = kr.fold_in(kr.key(3), torch.arange(N))[None]
    jkeys = jloggamma.fold_in_many(jax.random.key(3), jnp.arange(N))
    for k in np.flatnonzero(conc > 0):
        got = keyed_draw_picked(base, torch.arange(N), torch.zeros(N, dtype=torch.int64),
                                torch.from_numpy(c), torch.full((N,), int(k)), 3).numpy()[0]
        want = np.asarray(jserving._sampled_logp_picked(
            jkeys, jnp.asarray(c), jnp.full((N,), int(k))), np.float64)
        assert np.isfinite(got).all() and np.isfinite(want).all()
        assert st.ks_2samp(got, want).pvalue > 1e-3, (conc, k)
        se = np.sqrt(got.var() / N + want.var() / N)
        assert abs(got.mean() - want.mean()) < 5 * se, (conc, k)
        assert abs(np.log(got.var() / want.var())) < 0.1, (conc, k)
    zero = keyed_draw_picked(base, torch.arange(N), torch.zeros(N, dtype=torch.int64),
                             torch.from_numpy(c), torch.full((N,), A1 - 1), 3)
    assert bool(torch.isneginf(zero).all()) == (conc[-1] == 0)


# -- dispatch ---------------------------------------------------------------

def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    inputs = chip_smoke.keyed_draw_inputs(21, "float32", "cpu", shape=(2, 50, 5))
    before = keyed_draw.launches
    got = keyed_draw_picked(*inputs[:4], inputs[4], 4)
    assert torch.equal(got, keyed_draw_plain(*inputs[:4], 4, inputs[4]))
    assert keyed_draw_full(*inputs[:4], 4).shape == (2, 50, 21)
    assert keyed_draw.launches == before


def test_other_devices_and_bad_inputs_raise():
    base, group, rows, conc, nxt = chip_smoke.keyed_draw_inputs(5, "float32", "cpu",
                                                                shape=(2, 10, 3))
    meta = [t.to("meta") for t in (base, group, rows, conc, nxt)]
    with pytest.raises(ValueError, match="no path for device meta"):
        keyed_draw_picked(*meta[:4], meta[4], 3)
    with pytest.raises(ValueError, match="no path for device meta"):
        keyed_draw_full(*meta[:4], 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        keyed_draw_full(base, group, rows, conc.half(), 3)
    with pytest.raises(TypeError, match="int64 base keys"):
        keyed_draw_full(base.int(), group, rows, conc, 3)
    with pytest.raises(TypeError, match="integer nxt"):
        keyed_draw_picked(base, group, rows, conc, nxt.float(), 3)
    with pytest.raises(TypeError, match="integer rows"):
        keyed_draw_full(base, group, rows[:5], conc, 3)
    with pytest.raises(ValueError, match="categories"):
        keyed_draw_full(base, group, rows, torch.ones(10, 33), 3)
    with pytest.raises(ValueError, match="proposals"):
        keyed_draw_full(base, group, rows, conc, 0)
