"""The port's package surface against bear_tpu's: every name a bear_tpu
subpackage exports exists in the port's (less the JAX-only names); every
public class and function each bear_tpu module defines exists in the
port's module of the same path, and every public attribute of such a class
on the port's class (less the named exceptions, each with its reason); the
three functions the surface added agree with bear_tpu's, and every
bear-tpu-* console script has a bear-tpu-torch-* counterpart whose target
imports without JAX and answers --help.

Tolerances: row_to_context exact; ml_output_dm / ml_output_mult exact
(the same Gumbel noise, drawn by JAX and handed to the port)."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
import tomllib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bear_tpu.counting import engine as jengine
from bear_tpu.ops import distributions as jd
from bear_tpu_torch.counting import context_to_row, row_to_context
from bear_tpu_torch.ops import distributions as pd

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ["counting", "ops", "utils", "models", "inference", "data", "parallel"]
# Names of bear_tpu that exist only in JAX, by design: the port's AR
# functions are nn.Modules built by get_ar_func, and torch has no XLA
# compilation cache.
JAX_ONLY = {"models": {"ARFunc", "AR_FUNCS", "make_ar_func_attention", "make_ar_func_cnn",
                       "make_ar_func_linear", "make_ar_func_stop"},
            "utils": {"enable_compilation_cache"}}


# bear_tpu modules without a port module of the same path, by design.
NO_PORT_MODULE = {
    "bear_tpu.counting.pallas_hist": "the TPU kernel itself: its port is csrc/count_chunk.cu "
                                     "behind counting/count_chunk.py",
    "bear_tpu.counting._native_build": "builds bear_tpu's host library; the port builds its "
                                       "own with _build.build_host",
}
# Names a bear_tpu module defines (``Class.attribute`` for a class's) that
# its port module lacks, by design.
NOT_PORTED = {
    "bear_tpu.counting.engine": {
        # Selection among counting methods: the port has one kernel.
        "resolve_method": "picks scatter or sorted; the port always runs count_chunk",
        "device_nonzero": "the sorted method's on-device nonzero step",
        "TransitionCounter.SORTED_MIN_TRANSITIONS": "the sorted method's threshold",
    },
    "bear_tpu.models.ar_funcs": {
        # JAX-functional AR constructors: the port's AR functions are
        # nn.Modules built by get_ar_func.
        "ARFunc": "the (init, apply) pair of a JAX AR function",
        "make_ar_func_linear": "a JAX AR constructor",
        "make_ar_func_cnn": "a JAX AR constructor",
        "make_ar_func_stop": "a JAX AR constructor",
        "make_ar_func_attention": "a JAX AR constructor",
    },
    "bear_tpu.models.bear_ref": {
        "make_ref_ar_func": "a JAX AR constructor (the port's is make_ref_ar, a module)",
    },
    "bear_tpu.utils.cli_common": {
        "enable_compilation_cache": "XLA's compilation cache; torch has none",
    },
}


def _modules():
    """Every Python module under bear_tpu/, by dotted name (from the files:
    the list does not depend on what imports)."""
    names = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "bear_tpu")):
        rel = os.path.relpath(dirpath, REPO).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                names.append(f"{rel}.{f[:-3]}")
    return sorted(names)


def test_module_walk_finds_the_package():
    names = _modules()
    assert len(names) >= 30
    assert set(NO_PORT_MODULE) <= set(names) and set(NOT_PORTED) <= set(names)


@pytest.mark.parametrize("name", _modules())
def test_port_module_has_every_class_function_and_attribute(name):
    if name in NO_PORT_MODULE:
        return
    want = importlib.import_module(name)
    port = importlib.import_module("bear_tpu_torch" + name[len("bear_tpu"):])
    skip = NOT_PORTED.get(name, {})
    missing, checked = [], 0
    for attr, obj in vars(want).items():
        if attr.startswith("_") or getattr(obj, "__module__", None) != name or not (
                inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        checked += 1
        if attr in skip:
            assert not hasattr(port, attr), f"{attr} is ported: drop its exception"
            continue
        if not hasattr(port, attr):
            missing.append(attr)
            continue
        if inspect.isclass(obj):
            ported = getattr(port, attr)
            for member in dir(obj):
                if member.startswith("_") or f"{attr}.{member}" in skip:
                    continue
                if not hasattr(ported, member):
                    missing.append(f"{attr}.{member}")
    assert missing == []
    # Every exception names something bear_tpu still has.
    for key in skip:
        cls, _, member = key.partition(".")
        assert hasattr(getattr(want, cls), member) if member else hasattr(want, key), key
    assert checked or not skip


def _exported(sub):
    """The names bear_tpu/{sub}/__init__.py binds: its imports, and the
    names its module-level __getattr__ resolves lazily."""
    with open(os.path.join(REPO, "bear_tpu", sub, "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {c.value for c in ast.walk(node) if isinstance(c, ast.Constant)
                      and isinstance(c.value, str) and c.value.isidentifier()}
    return sorted(names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_bear_tpu_name(sub):
    want = importlib.import_module(f"bear_tpu.{sub}")
    port = importlib.import_module(f"bear_tpu_torch.{sub}")
    names = _exported(sub)
    assert len(names) >= 4
    missing = []
    for name in names:
        if name in JAX_ONLY.get(sub, ()):
            continue
        if isinstance(getattr(want, name), types.ModuleType):
            # A submodule bound on the package: the port has its own.
            try:
                importlib.import_module(f"bear_tpu_torch.{sub}.{name}")
            except ImportError:
                missing.append(name)
        elif not hasattr(port, name):
            missing.append(name)
    assert missing == []
    assert not any(hasattr(port, n) for n in JAX_ONLY.get(sub, ()))


@pytest.mark.parametrize("alphabet,lag", [("dna", 1), ("dna", 6), ("dna", 13),
                                          ("prot", 1), ("prot", 6), ("prot", 13)])
def test_row_to_context_matches_bear_tpu(alphabet, lag):
    A = 20 if alphabet == "prot" else 4
    n_rows = (A ** (lag + 1) - 1) // (A - 1)
    rng = np.random.default_rng(lag)
    rows = np.unique(np.concatenate([[0, n_rows - 1], rng.integers(0, n_rows, 64)]))
    for row in rows:
        got = row_to_context(int(row), lag, alphabet)
        assert isinstance(got, str)
        assert got == jengine.row_to_context(int(row), lag, alphabet)
        assert context_to_row(got, lag, alphabet) == row


@pytest.mark.parametrize("name", ["ml_output_dm", "ml_output_mult"])
def test_ml_output_dm_mult_match_bear_tpu(name):
    # Tied and tie-free rows: with JAX's Gumbel noise handed over, the
    # port picks what bear_tpu picks from the same key, and equals ml_output.
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 3, size=(400, 5)).astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        gumbel = np.array(jax.random.gumbel(key, scores.shape, dtype=jnp.float32))
        want = np.asarray(getattr(jd, name)(scores, key))
        got = getattr(pd, name)(torch.from_numpy(scores), gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), pd.ml_output(torch.from_numpy(scores),
                                      gumbel=torch.from_numpy(gumbel)).numpy())
    gen = torch.Generator().manual_seed(0)
    assert getattr(pd, name)(torch.from_numpy(scores), gen).shape == (400,)


def _scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)["project"]["scripts"]


def test_every_console_script_has_a_torch_counterpart():
    scripts = _scripts()
    jax_names = [n for n in scripts if not n.startswith("bear-tpu-torch-")]
    assert len(jax_names) == 7
    for name in jax_names:
        port = name.replace("bear-tpu-", "bear-tpu-torch-", 1)
        assert port in scripts, port
        assert scripts[port] == scripts[name].replace("bear_tpu.", "bear_tpu_torch.", 1)
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        extras = tomllib.load(fh)["project"]["optional-dependencies"]
    assert extras["torch"] == ["torch"]


@pytest.mark.parametrize("name", sorted(n for n in _scripts() if n.startswith("bear-tpu-torch-")))
def test_torch_console_script_imports_without_jax_and_answers_help(name):
    module, func = _scripts()[name].split(":")
    code = (
        "import importlib, sys\n"
        "jax = lambda: [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'bear_tpu')]\n"
        f"fn = getattr(importlib.import_module({module!r}), {func!r})\n"
        "assert jax() == [], jax()\n"
        f"sys.argv = [{name!r}, '--help']\n"
        "try:\n"
        "    fn()\n"
        "    code = 0\n"
        "except SystemExit as e:\n"
        "    code = e.code or 0\n"
        "assert jax() == [], jax()\n"
        "sys.exit(code)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage:" in out.stdout
