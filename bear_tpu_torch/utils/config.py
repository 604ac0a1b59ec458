"""Reference-compatible config front end (port of bear_tpu/utils/config.py).

The reference drives everything from configparser INI files with sections
[general] [data] [hyperp] [train] [test] [model] [results]; the same files
and key names run here, read into a typed dataclass.

Semantics kept:
- out_folder 'TEST' -> package-local models/out_data/logs/<timestamp>;
  a trailing '*' -> the path literally (mkdir -p); otherwise
  out_folder/logs/<timestamp>.
- files_path 'TEST' -> the bundled YSD1 counts (the port's own copy).
- batch_size <= 1 -> a fraction of num_kmers.
- epochs with a trailing 's' -> a step count converted to epochs.

- [train] streaming feeds training and evaluation one count file at a
  time; cache (default True) keeps each parsed file as an .npz in the out
  folder for later epochs; checkpoint_every > 0 writes the mid-run train
  state every N optimizer applies and resumes from it.

- [data] reference_column (default -1) is the reference column of the
  reference-guided CLI (train_bear_ref).

- [model] compute_precision ('' or 'none', 'bfloat16', 'float32') runs
  the AR network in that type (``RunConfig.compute_dtype``) while the
  parameters and the likelihood stay in ``precision``.

- [train] data_parallel = True splits every batch over all local devices
  (a ``data_parallel_mesh``), the CLI's counterpart of passing ``mesh=``
  to training and evaluation (a bear_tpu extension).
"""

from __future__ import annotations

import configparser
import datetime
import json
import os
from dataclasses import dataclass, field

import torch

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURES_DIR = os.path.join(_PACKAGE_ROOT, "data", "fixtures")


def bundled_ysd1_path() -> str:
    """Bundled YSD1 phage lag-5 transition counts (the published-table
    parity fixture)."""
    return os.path.join(_FIXTURES_DIR, "ysd1_lag_5_file_0_preshuf.tsv")


def bundled_sparse_path() -> str:
    """Bundled sparse-format toy counts."""
    return os.path.join(_FIXTURES_DIR, "ex_seqs_kmap_for_var_pred.csv")


@dataclass
class RunConfig:
    # [general]
    out_folder: str
    seed: int
    precision: str
    # [data]
    files_path: str
    start_token: str
    sparse: bool
    num_ds: int
    alphabet: str
    train_column: int
    test_column: int
    reference_column: int
    # [hyperp]
    lag: int
    # [train]
    train: bool
    epochs_raw: str
    batch_size_raw: float
    optimizer_name: str
    learning_rate: float
    train_ar: bool
    accumulation_steps: int
    restart: bool
    restart_path: str
    # [test]
    test: bool
    train_test: bool
    van_reg: list
    # [model]
    ar_func_name: str
    af_kwargs: dict = field(default_factory=dict)
    shuffle: bool = False  # [train] shuffle: in memory one seeded permutation
    # per run; streaming a per-epoch file order and in-file permutation
    cache: bool = True  # [train] cache: parsed-shard .npz cache when streaming
    streaming: bool = False  # [train] streaming: one count file at a time
    checkpoint_every: int = 0  # [train] checkpoint_every: mid-run state cadence
    compute_precision: str = ""  # [model] compute_precision: the AR network's type
    data_parallel: bool = False  # [train] data_parallel: batches over all local devices

    @classmethod
    def from_configparser(cls, config: configparser.ConfigParser) -> "RunConfig":
        g, d, hp = config["general"], config["data"], config["hyperp"]
        tr, te, mo = config["train"], config["test"], config["model"]
        return cls(
            out_folder=g["out_folder"],
            seed=int(g["seed"]),
            precision=g["precision"],
            files_path=d["files_path"],
            start_token=d["start_token"],
            sparse=d["sparse"] == "True",
            num_ds=int(d["num_ds"]),
            alphabet=d["alphabet"],
            train_column=int(d["train_column"]),
            test_column=int(d["test_column"]),
            reference_column=int(d.get("reference_column", "-1")),
            lag=int(hp["lag"]),
            train=tr["train"] == "True",
            epochs_raw=tr["epochs"],
            batch_size_raw=float(tr["batch_size"]),
            optimizer_name=tr["optimizer_name"],
            learning_rate=float(tr["learning_rate"]),
            train_ar=tr["train_ar"] == "True",
            accumulation_steps=int(tr["accumulation_steps"]),
            restart=tr.get("restart", "False") == "True",
            restart_path=tr.get("restart_path", ""),
            shuffle=tr.get("shuffle", "False") == "True",
            cache=tr.get("cache", "True") == "True",
            streaming=tr.get("streaming", "False") == "True",
            checkpoint_every=int(tr.get("checkpoint_every", "0")),
            data_parallel=tr.get("data_parallel", "False") == "True",
            test=te["test"] == "True",
            train_test=te["train_test"] == "True",
            van_reg=json.loads(te["van_reg"]),
            ar_func_name=mo["ar_func_name"],
            af_kwargs=json.loads(mo["af_kwargs"]),
            compute_precision=mo.get("compute_precision", ""),
        )

    @classmethod
    def read(cls, path: str) -> tuple["RunConfig", configparser.ConfigParser]:
        config = configparser.ConfigParser()
        if not config.read(path):
            raise FileNotFoundError(f"config file not found/unreadable: {path}")
        if "results" not in config:
            config["results"] = {}
        return cls.from_configparser(config), config

    def resolve_out_folder(self) -> str:
        time_stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        if self.out_folder == "TEST":
            out = os.path.join(_PACKAGE_ROOT, "models", "out_data", "logs", time_stamp)
        elif self.out_folder.endswith("*"):
            out = self.out_folder[:-1]
        else:
            out = os.path.join(self.out_folder, "logs", time_stamp)
        os.makedirs(out, exist_ok=True)
        return out

    def resolve_files(self) -> list[str]:
        if self.files_path == "TEST":
            return [bundled_ysd1_path()]
        from bear_tpu_torch.data import discover_files

        return discover_files(self.files_path, self.start_token)

    def resolve_batch_size(self, num_kmers: int) -> int:
        b = self.batch_size_raw
        return int(num_kmers * b) if b <= 1 else int(b)

    def resolve_epochs(self, num_kmers: int, batch_size: int) -> int:
        if self.epochs_raw.endswith("s"):
            return int(self.epochs_raw[:-1]) // (1 + num_kmers // batch_size) + 1
        return int(self.epochs_raw)

    def dtype(self) -> torch.dtype:
        return torch.float64 if self.precision == "float64" else torch.float32

    def compute_dtype(self):
        """The AR network's compute type ([model] compute_precision), or None
        to compute in ``precision``."""
        if self.compute_precision in ("", "none"):
            return None
        if self.compute_precision == "bfloat16":
            return torch.bfloat16
        if self.compute_precision == "float32":
            return torch.float32
        raise ValueError(
            f"unknown compute_precision {self.compute_precision!r} "
            "(expected '', 'bfloat16' or 'float32')"
        )
