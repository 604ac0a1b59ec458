"""The port's metrics writer and profiling hooks (bear_tpu_torch.utils)
against bear_tpu's behaviour, on the CPU."""

import json

import pytest
import torch

from bear_tpu.utils.metrics import MetricsWriter as JMetricsWriter
from bear_tpu.utils.profiling import StageTimer as JStageTimer
from bear_tpu_torch.utils import MetricsWriter, StageTimer, trace

torch.set_num_threads(2)


def _lines(path, keys=("tag", "value", "step")):
    return [{k: json.loads(line)[k] for k in keys} for line in open(path)]


def _write(writer_cls, timer_cls, out):
    w = writer_cls(str(out), tensorboard=False)
    w.scalar("elbo", 1.5, step=3)
    timer = timer_cls(writer=w)
    with timer.stage("phase_a"):
        pass
    w.flush()
    report = timer.report()
    w.close()
    w.close()  # idempotent
    return w.path, timer, report


def test_metrics_writer_and_stage_timer_match_bear_tpu(tmp_path):
    """Mirror of tests/test_utils.py::test_metrics_writer_and_stage_timer:
    the same scalars.jsonl records (times aside) and stage names."""
    path, timer, report = _write(MetricsWriter, StageTimer, tmp_path / "port")
    jpath, jtimer, _ = _write(JMetricsWriter, JStageTimer, tmp_path / "jax")
    assert _lines(path, ("tag", "step")) == _lines(jpath, ("tag", "step"))
    assert _lines(path)[0] == {"tag": "elbo", "value": 1.5, "step": 3}
    assert _lines(path)[1]["tag"] == "stage_seconds/phase_a"
    assert [n for n, _ in timer.stages] == [n for n, _ in jtimer.stages] == ["phase_a"]
    assert "phase_a" in report
    alone = StageTimer()
    with pytest.raises(KeyError):  # a failing stage is still timed
        with alone.stage("fails"):
            raise KeyError
    assert [n for n, _ in alone.stages] == ["fails"]


@pytest.mark.parametrize("switch", ["argument", "environment"])
def test_metrics_writer_tensorboard_tee(tmp_path, monkeypatch, switch):
    """Mirror of tests/test_utils.py::test_metrics_writer_tensorboard: event
    files under tb/ beside scalars.jsonl, asked for by the argument or by
    BEAR_TPU_TENSORBOARD=1; without either, none."""
    if switch == "environment":
        monkeypatch.setenv("BEAR_TPU_TENSORBOARD", "1")
        w = MetricsWriter(str(tmp_path))
    else:
        w = MetricsWriter(str(tmp_path), tensorboard=True)
    w.scalar("elbo", 1.5, step=1)
    w.scalar("elbo", 2.5, step=2)
    w.close()
    w.close()
    assert len(_lines(tmp_path / "scalars.jsonl")) == 2
    tb_dir = tmp_path / "tb"
    assert tb_dir.exists() and any(f.name.startswith("events") for f in tb_dir.iterdir())
    monkeypatch.delenv("BEAR_TPU_TENSORBOARD", raising=False)
    MetricsWriter(str(tmp_path / "plain")).close()
    assert not (tmp_path / "plain" / "tb").exists()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        y = (x @ x).sum()
    assert torch.isfinite(y)
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
