"""The port's spans (bear_tpu_torch.utils.profiling.span), on the CPU: off
with no profiler running, nested and closed inside one, agreeing with the
profiler's own host events, and recorded at the layer boundaries of
training, scoring and counting under one root per call."""

import contextlib
import gc
import time

import numpy as np
import pytest
import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile

from bear_tpu_torch.counting import ReadChunk, TransitionCounter
from bear_tpu_torch.counting.count_chunk import table_rows
from bear_tpu_torch.data import load_dense
from bear_tpu_torch.inference.serving import BearServer
from bear_tpu_torch.models import bear_net
from bear_tpu_torch.models.ar_funcs import get_ar_func
from bear_tpu_torch.ops import keyed_random as kr
from bear_tpu_torch.utils import StageTimer, profiling
from bear_tpu_torch.utils.config import bundled_ysd1_path
from bear_tpu_torch.utils.profiling import recorded, span

torch.set_num_threads(2)


@pytest.fixture
def traced():
    """A CPU profile with the recorded spans cleared before it opens."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof
    profiling.clear()


def _names(records):
    return [r.name for r in records]


def _one_root(records, root_name):
    """Every record under the first one, which is ``root_name``."""
    assert records and records[0].name == root_name and records[0].parent is None
    assert all(r.root == 0 for r in records), [(r.name, r.root) for r in records]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in records)


def test_profiler_enabled_only_inside_a_profile():
    """``span`` switches on ``torch.autograd._profiler_enabled()``."""
    assert not _profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert _profiler_enabled()
    assert not _profiler_enabled()


def test_span_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    with span("bear.outer"):
        with span("bear.inner"):
            pass
    with pytest.raises(KeyError):
        with span("bear.raises"):
            raise KeyError
    assert recorded() == []


def test_nested_spans_record_parent_root_and_the_profilers_times():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("bear.a"):
            with span("bear.b"):
                with span("bear.c"):
                    time.sleep(0.002)
            with span("bear.d"):
                time.sleep(0.001)
        with pytest.raises(KeyError):
            with span("bear.raises"):
                raise KeyError
        with span("bear.after"):
            pass
    recs = recorded()
    profiling.clear()
    assert _names(recs) == ["bear.a", "bear.b", "bear.c", "bear.d", "bear.raises",
                            "bear.after"]
    assert [r.parent for r in recs] == [None, 0, 1, 0, None, None]
    assert [r.root for r in recs] == [0, 0, 0, 0, 4, 5]
    assert all(r.end_ns is not None for r in recs), "a span whose body raises is closed"
    a, b, c, d = recs[:4]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for r in recs:
        assert len(events.get(r.name, [])) == 1, r.name
        ours, theirs = (r.end_ns - r.start_ns) / 1e3, events[r.name][0]
        assert abs(ours - theirs) <= max(0.2 * theirs, 100.0), (r.name, ours, theirs)


def test_spans_keep_no_object_for_the_garbage_collector(traced):
    """A record per span kept as an object sets off collections, which
    under the profiler cost tenths of a second in a training call."""
    with span("bear.warm"):
        pass
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(1000):
        with span("bear.x"):
            pass
    gc.collect()
    assert len(gc.get_objects()) - before < 100
    assert len(recorded()) == 1001


def test_clear_drops_a_span_open_across_it(traced):
    with span("bear.open"):
        with span("bear.before"):
            pass
        profiling.clear()
        with span("bear.after"):
            pass
    with span("bear.next"):
        pass
    recs = recorded()
    assert _names(recs) == ["bear.after", "bear.next"]
    assert [(r.parent, r.root) for r in recs] == [(None, 0), (None, 1)]
    assert all(r.end_ns is not None for r in recs)


def test_trace_clears_the_records_on_entry(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("bear.before"):
            pass
    assert _names(recorded()) == ["bear.before"]
    with profiling.trace(str(tmp_path / "prof")):
        with span("bear.inside"):
            pass
    assert _names(recorded()) == ["bear.inside"]
    profiling.clear()
    assert recorded() == []


@pytest.mark.parametrize("fails", [False, True])
def test_stage_timer_stage_is_a_span_ending_in_a_synchronize(monkeypatch, fails):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("sync"))
    timer = StageTimer()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError) if fails else contextlib.nullcontext():
            with timer.stage("stage_a"):
                calls.append("body")
                if fails:
                    raise KeyError
    assert calls == ["body", "sync"]
    assert [n for n, _ in timer.stages] == ["stage_a"]
    (rec,) = recorded()
    assert rec.name == "stage_a" and rec.end_ns is not None
    profiling.clear()


def test_train_records_its_layers_under_one_root_per_call(traced):
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    ar = get_ar_func("linear", 5, 4, dtype=torch.float32, device="cpu")
    batch, epochs = 500, 2
    kw = dict(num_kmers=ds.num_kmers, ar_func=ar, batch_size=batch, epochs=epochs,
              learning_rate=0.01, dtype=torch.float32, device="cpu")
    res = bear_net.train(ds.codes, ds.counts[:, 0], **kw)
    first = recorded()
    bear_net.train(ds.codes, ds.counts[:, 0], params_restart=[res.params["h_signed"]]
                   + list(res.params["ar"]), opt_state_restart=res.opt_state, **kw)
    recs = recorded()
    applies = -(-ds.codes.shape[0] // batch) * epochs
    assert len(res.losses) == applies
    _one_root(first, "bear.train.call")
    second = recs[len(first):]
    assert second[0].name == "bear.train.call" and second[0].parent is None
    assert all(r.root == len(first) for r in second)
    for call in (first, second):
        names = _names(call)
        assert names.count("bear.train.apply") == applies
        assert names.count("bear.train.forward") == names.count("bear.train.backward") == applies
        assert names.count("bear.train.prepare") == names.count("bear.train.finish") == 1
        base = call[0].root
        for r in call:
            parent = None if r.parent is None else recs[r.parent].name
            want = {"bear.train.call": None, "bear.train.forward": "bear.train.apply",
                    "bear.train.backward": "bear.train.apply"}.get(r.name, "bear.train.call")
            assert parent == want, (r.name, parent)
            assert r.root == base


def test_streaming_train_records_applies_and_per_shard_prepares(traced):
    ds = load_dense(bundled_ysd1_path(), "dna", 3)
    ar = get_ar_func("linear", 5, 4, dtype=torch.float32, device="cpu")
    n = ds.codes.shape[0]
    shards = [(ds.codes[: n // 2], ds.counts[: n // 2, 0]),
              (ds.codes[n // 2:], ds.counts[n // 2:, 0])]
    res = bear_net.train_streaming(lambda: shards, ds.num_kmers, ar, batch_size=400,
                                   epochs=1, dtype=torch.float32, device="cpu")
    recs = recorded()
    _one_root(recs, "bear.train.call")
    names = _names(recs)
    assert names.count("bear.train.apply") == len(res.losses)
    assert names.count("bear.train.prepare") == 1 + len(shards)  # _start, then each shard
    assert names.count("bear.train.finish") == 1


def test_sampled_score_records_its_layers_under_one_root(traced):
    rng = np.random.default_rng(4)
    lag = 3
    table = rng.integers(0, 20, size=(table_rows(lag, 4), 5)).astype(np.int32)
    server = BearServer(table, lag, van=0.5, device="cpu")
    seqs = ["".join(rng.choice(list("ACGT"), size=int(k))) for k in (7, 12, 3)]
    out = server.score(seqs, mode="sample", key=kr.key(11), mc_samples=3, reduce="mean_std")
    assert out.shape == (3, 2)
    recs = recorded()
    _one_root(recs, "bear.score.call")
    assert _names(recs)[1:] == ["bear.score.encode", "bear.score.rows", "bear.score.mask",
                                "bear.score.concentrations", "bear.score.draw",
                                "bear.score.assemble", "bear.score.reduce",
                                "bear.score.copy_out"]
    assert all(r.parent == 0 for r in recs[1:])


def test_add_chunk_records_its_layers_under_one_root(traced):
    rng = np.random.default_rng(5)
    B, L = 16, 20
    chunk = ReadChunk(rng.integers(0, 4, size=(B, L)).astype(np.int8),
                      np.full(B, L, np.int32), np.zeros(B, np.int32), np.ones(B, bool),
                      np.zeros(B, np.int32))
    counter = TransitionCounter(lags=[4], device="cpu")
    counter.add_chunk(chunk)
    first = recorded()
    counter.add_chunk(chunk)
    counter.flush()
    recs = recorded()
    _one_root(first, "bear.count.add_chunk")
    # The CPU path has no staging: the card's stage spans are tested on the card.
    assert _names(first) == ["bear.count.add_chunk", "bear.count.table_alloc",
                             "bear.count.launch"]
    assert _names(recs[len(first):]) == ["bear.count.add_chunk", "bear.count.launch",
                                         "bear.count.flush"]
    assert recs[-1].parent is None
    assert int(counter.tables[4].sum()) == 2 * B * (L + 1)
