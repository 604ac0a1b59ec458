"""Import hygiene of the port: bear_tpu_torch imports neither JAX nor
bear_tpu, chip_smoke.py refuses to run without a card, and the package data
ships every file the port reads at run time."""

import ast
import fnmatch
import os
import pkgutil
import shutil
import subprocess
import sys
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bear_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "bear_tpu")


def _forbidden(name: str) -> bool:
    # bear_tpu_torch shares a prefix with bear_tpu; only the exact name or a
    # dotted submodule counts.
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return ["bear_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], prefix="bear_tpu_torch.")
    ]


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"bear_tpu_torch.counting.window_hist", "bear_tpu_torch.counting.engine",
            "bear_tpu_torch.counting.count_chunk",
            "bear_tpu_torch.inference.serving", "bear_tpu_torch.inference.scoring",
            "bear_tpu_torch.models.ar_funcs", "bear_tpu_torch.models.bear_net",
            "bear_tpu_torch.ops.alphabets", "bear_tpu_torch.ops.distributions",
            "bear_tpu_torch.counting.fastx", "bear_tpu_torch.utils.checkpoint",
            "bear_tpu_torch.data.loaders", "bear_tpu_torch.data.likelihood",
            "bear_tpu_torch.models.train_bear_net", "bear_tpu_torch.utils.config",
            "bear_tpu_torch.ops.keyed_random", "bear_tpu_torch.ops.loggamma",
            "bear_tpu_torch.inference.score_cli",
            "bear_tpu_torch.utils.cli_common", "bear_tpu_torch.utils.metrics",
            "bear_tpu_torch.counting.native", "bear_tpu_torch.counting.summarize",
            "bear_tpu_torch.counting.check_summarize",
            "bear_tpu_torch.models.bear_ref", "bear_tpu_torch.models.train_bear_ref",
            "bear_tpu_torch.models.vbear", "bear_tpu_torch.models.lag_selection",
            "bear_tpu_torch.models.lag_select_cli", "bear_tpu_torch.inference.assemble",
            "bear_tpu_torch.inference.assemble_cli", "bear_tpu_torch.counting.multipass",
            "bear_tpu_torch.counting.sparse", "bear_tpu_torch.parallel",
            "bear_tpu_torch.parallel.counting", "bear_tpu_torch.parallel.mesh",
            "bear_tpu_torch.parallel.multihost"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "torch" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("first", ["bear_tpu_torch.parallel", "bear_tpu_torch.parallel.counting",
                                   "bear_tpu_torch.counting.sparse",
                                   "bear_tpu_torch.parallel.mesh",
                                   "bear_tpu_torch.parallel.multihost"])
def test_row_split_counters_import_first(first):
    # parallel.counting and the counting package import each other's
    # modules; either may be imported first in a fresh interpreter.
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    code = (f"import {first}\nfrom bear_tpu_torch.counting import MultiPassTransitionCounter, "
            "SparseTransitionCounter\nfrom bear_tpu_torch.parallel import "
            "KmerShardedTransitionCounter as K\n"
            "assert issubclass(MultiPassTransitionCounter, K) and "
            "issubclass(SparseTransitionCounter, K)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_forbidden_import_statements():
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                hits += [(path, n) for n in names if _forbidden(n)]
    assert hits == []
    assert not _forbidden("bear_tpu_torch") and _forbidden("bear_tpu.ops")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=os.path.dirname(script), env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_package_data_ships_kernel_sources_and_fixtures():
    # A non-editable install holds only what package-data lists: every
    # kernel source and shared header (nvcc builds them at first use) and
    # every data fixture must match one of the globs.
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["bear_tpu_torch"]
    wanted = []
    for sub, patterns in (("csrc", ("*.cu", "*.cuh", "*.cpp")), ("data/fixtures", ("*",))):
        for name in os.listdir(os.path.join(PKG, sub)):
            if os.path.isfile(os.path.join(PKG, sub, name)) and any(
                    fnmatch.fnmatch(name, p) for p in patterns):
                wanted.append(f"{sub}/{name}")
    assert "csrc/hist_add.cuh" in wanted and "csrc/fastx.cpp" in wanted and "data/fixtures/ysd1_lag_5_file_0_preshuf.tsv" in wanted
    missing = [w for w in wanted if not any(fnmatch.fnmatch(w, g) for g in globs)]
    assert missing == []
