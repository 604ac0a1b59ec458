"""What the benchmark may import, compared by whole top-level module names:
nothing of JAX or of the JAX package, anywhere; and in the reference,
nothing of the program either."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from bench_gpu import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bear_tpu"}
PROGRAM = "bear_tpu_torch"


def _sources(sub=""):
    base = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_names_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_top_names(path)) & FORBIDDEN, path


def test_the_reference_names_nothing_of_the_program():
    for path in _sources("reference"):
        assert PROGRAM not in set(_top_names(path)), path


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_of_every_cell_loads_no_forbidden_module():
    """Every module that a run imports, the program's included: a run of
    each small cell, traced and not, then the top-level names loaded."""
    code = ("import sys, json; sys.path.insert(0, '.'); from bench_gpu import tiny_cells; "
            "[tiny_cells.run(c, trace=t) for c in tiny_cells.CELLS for t in (False, True)]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _loaded_after(code)
    assert PROGRAM in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, '.'); "
            "import bench_gpu.reference.counts, bench_gpu.reference.model, "
            "bench_gpu.reference.sampler; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {PROGRAM})


@pytest.mark.parametrize("names,found", [(["jax.numpy", "os"], ["jax"]),
                                         (["bear_tpu.models"], ["bear_tpu"]),
                                         (["bear_tpu_torch.ops", "jaxtyping"], [])])
def test_the_runs_own_look_compares_whole_names(names, found):
    assert harness.forbidden_loaded(names) == found
