"""The port's scoring CLI (bear_tpu_torch.inference.score_cli) against
bear_tpu's on one tiny trained model, with ``--torch-device cpu``: MAP and
marginal columns equal to the printed 6 decimals (±1 in the last digit),
sampled columns of the same shape, and the same refusals as
tests/test_score_cli.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from bear_tpu.inference.score_cli import main as jmain
from bear_tpu_torch.inference.score_cli import main
from bear_tpu_torch.models import train_bear_net

torch.set_num_threads(2)
CPU = ["--torch-device", "cpu"]
WT = "ACGTACGTTGCAATG"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A linear BEAR trained by the port for 5 applies on the bundled YSD1
    counts (lag 5), in float64."""
    out = str(tmp_path_factory.mktemp("scoremodel") / "model")
    cfg = chip_smoke.ysd1_config(out + "*")
    cfg["general"]["precision"] = "float64"
    cfg["train"]["epochs"] = "5"
    cfg["test"].update(test="False", train_test="False")
    train_bear_net.main(cfg, device="cpu")
    return out


def _table(fn, argv, capsys):
    assert fn(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return lines[0], [l.split("\t") for l in lines[1:]]


def _same_values(rows, jrows):
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    got = np.array([[float(x) for x in r[1:]] for r in rows])
    want = np.array([[float(x) for x in r[1:]] for r in jrows])
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01e-6)


def test_snv_map_matches_bear_tpu(model_dir, capsys):
    for argv in (["snv", model_dir, WT, "A0C", "G2T", "T3A", "G14A"],
                 ["snv", model_dir, WT, "--all"],
                 ["snv", model_dir, WT, "--all", "--batch", "7"]):
        head, rows = _table(main, argv + CPU, capsys)
        jhead, jrows = _table(jmain, argv, capsys)
        assert head == jhead == "variant\tBEAR"
        _same_values(rows, jrows)
    assert len(rows) == 3 * len(WT)


def test_snv_sampled_has_bear_tpu_columns(model_dir, capsys):
    argv = ["snv", model_dir, WT, "--all", "--sample", "--mc-samples", "9", "--std"]
    head, rows = _table(main, argv + CPU, capsys)
    jhead, jrows = _table(jmain, argv, capsys)
    assert head == jhead == "variant\tBEAR\tmc_std"
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    vals = np.array([[float(x) for x in r[1:]] for r in rows])
    assert np.isfinite(vals).all() and (vals[:, 1] >= 0).all()
    # the same seed gives the same table; another seed another
    assert _table(main, argv + CPU, capsys)[1] == rows
    assert _table(main, argv + ["--seed", "1"] + CPU, capsys)[1] != rows


def test_variants_and_seqs_match_bear_tpu(model_dir, capsys, tmp_path):
    vars_ = ["A0C", "G2T", "GT2CA", "T3", "0GG", "15A"]
    for argv in (["variants", model_dir, WT, *vars_, "--map", "--van", "1.0"],
                 ["variants", model_dir, WT, *vars_, "--map", "--device"],
                 ["seqs", model_dir, WT, "TTTTACG", "GATTACA", "--map", "--van", "0.5"],
                 ["seqs", model_dir, WT, "GATTACA", "--marg", "--van", "0.5"]):
        head, rows = _table(main, argv + CPU, capsys)
        jhead, jrows = _table(jmain, argv, capsys)
        assert head == jhead
        _same_values(rows, jrows)
    fasta = tmp_path / "s.fa"
    fasta.write_text(">one\nACGTTGCA\n>two\nGGGATTT\n")
    argv = ["seqs", model_dir, "--fasta", str(fasta), "--map"]
    head, rows = _table(main, argv + CPU, capsys)
    _same_values(rows, _table(jmain, argv, capsys)[1])
    assert [r[0] for r in rows] == ["one", "two"]
    # sampled host and device routes: bear_tpu's columns, finite values
    for argv in (["variants", model_dir, WT, *vars_, "--mc-samples", "5"],
                 ["variants", model_dir, WT, *vars_, "--mc-samples", "5", "--device"],
                 ["seqs", model_dir, WT, "GATTACA", "--mc-samples", "5", "--van", "1"]):
        head, rows = _table(main, argv + CPU, capsys)
        jhead, jrows = _table(jmain, argv, capsys)
        assert head == jhead and [r[0] for r in rows] == [r[0] for r in jrows]
        assert np.isfinite([[float(x) for x in r[1:]] for r in rows]).all()


def test_refusals(model_dir, capsys):
    for argv in (["snv", model_dir, "ACGTAC", "C0T"],  # wild-type mismatch
                 ["snv", model_dir, "ACGTAC", "AC0GT"],  # not an SNV
                 ["snv", model_dir, "ACGTAC"],  # nothing to score
                 ["snv", model_dir, "ACGTAC", "A0G", "--std"],  # --std needs --sample
                 ["snv", model_dir, "ACGTAC", "A0G", "--all"],
                 ["seqs", model_dir, "ACGTAC", "--map", "--marg"],
                 ["snv", model_dir, "ACGTAC", "A0G", "--torch-device", "tpu"]):
        with pytest.raises(SystemExit):
            main(argv + (CPU if "--torch-device" not in argv else []))
    assert main(["seqs", model_dir] + CPU) == 2
    assert "no sequences" in capsys.readouterr().err
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["snv", model_dir, "ACGTAC", "A0G"])
