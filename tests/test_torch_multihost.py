"""The port across processes (bear_tpu_torch.parallel.multihost) in real
processes. Counting: two gloo processes each count their host_shard of the
reads and merge with allreduce_tables; every rank's tables must equal
bear_tpu's single-process count of all the reads, and a repeated merge
must change nothing (the counterparts of tests/test_multihost.py's
counting tests). Training over a mesh that spans both processes
(tests/test_multihost.py:248 and :445): every rank's ELBOs, parameters and
metrics are bit-equal and match bear_tpu's single-process run; a shared
checkpoint directory resumes identically on both ranks, rank-local ones
with diverged state abort both. A row-split server over both processes
scores as the dense table does, exactly.

The workers import only the port (no JAX); each has a timeout, and the
group's own timeout fails a lost peer within a minute. The bear_tpu oracle
runs in the test's own process.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting.sparse import SparseTransitionCounter as JSparse
from bear_tpu.inference.serving import BearServer as JServer
from bear_tpu.models import bear_net as jbn
from bear_tpu.models import get_ar_func as jget_ar_func

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from bear_tpu_torch.parallel import Mesh, multihost
    spec_path, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    with open(spec_path) as fh:
        spec = json.load(fh)
    nproc = spec["nproc"]
    for _ in range(2):  # the repeat is a no-op
        multihost.initialize(f"127.0.0.1:{{port}}", nproc, pid, timeout_s=60)
    assert multihost.process_count() == nproc and multihost.process_index() == pid
    from bear_tpu_torch.counting import engine, fastx
    from bear_tpu_torch.counting.sparse import SparseTransitionCounter
    from bear_tpu_torch.parallel import KmerShardedTransitionCounter, ShardedTransitionCounter

    mode, lags = spec["mode"], spec["lags"]
    cpu2 = lambda axis: Mesh([torch.device("cpu")] * 2, (axis,))
    tc = {{
        "dense": lambda: engine.TransitionCounter(lags, n_groups=2, device="cpu"),
        "data_sharded": lambda: ShardedTransitionCounter(cpu2("data"), lags, n_groups=2),
        "row_split": lambda: KmerShardedTransitionCounter(lags, n_groups=2, mesh=cpu2("kmer")),
        "sparse_first": lambda: SparseTransitionCounter(lags, n_groups=2, device_buffer=128,
                                                        device="cpu"),
    }}[mode]()

    def count(seqs):
        mine = multihost.host_shard(seqs)
        assert 0 < len(mine) < len(seqs)  # really sharded
        enc = ((fastx.encode_seq(s), i % 2) for i, s in mine)
        for chunk in engine.chunk_reads(enc, max(lags), batch_size=3):
            tc.add_chunk(chunk)

    def tables():
        if hasattr(tc, "_sparse"):
            return {{f"{{k}}_{{l}}": a for l in lags
                    for k, a in zip(("keys", "vals"), tc._consolidated(l))}}
        return {{f"table_{{l}}": t for l, t in tc.tables.items()}}

    seqs = list(enumerate(spec["seqs"]))
    half = len(seqs) // 2
    count(seqs[:half])
    multihost.allreduce_tables(tc)  # a merge while streaming
    count(seqs[half:])
    multihost.allreduce_tables(tc)
    once = tables()
    multihost.allreduce_tables(tc)  # repeated: must not double
    twice = tables()
    local = np.array([sum(len(s) + 1 for _, s in multihost.host_shard(seqs)), 2**40 + pid])
    total = multihost.allreduce_sum_i64(local)
    np.savez(out, total=total, **{{"once_" + k: v for k, v in once.items()}},
             **{{"twice_" + k: v for k, v in twice.items()}})
    torch.distributed.destroy_process_group()
    print(f"proc {{pid}} OK")
    """
).format(repo=REPO)

CASES = {  # mode -> lags (the worker counts all of them in one counter)
    "dense": [2, 5],
    "data_sharded": [3],
    "row_split": [1, 3],
    "sparse_first": [17],
}


MESH_WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from bear_tpu_torch.parallel import multihost
    spec_path, pid, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    with open(spec_path) as fh:
        spec = json.load(fh)
    nproc, mode = spec["nproc"], spec["mode"]
    multihost.initialize(f"127.0.0.1:{{port}}", nproc, pid, timeout_s=60)
    from bear_tpu_torch.counting import engine, fastx
    from bear_tpu_torch.inference.serving import BearServer
    from bear_tpu_torch.models import bear_net
    from bear_tpu_torch.models.ar_funcs import get_ar_func
    from bear_tpu_torch.ops import keyed_random as kr
    from bear_tpu_torch.parallel import data_parallel_mesh, grid_mesh
    from bear_tpu_torch.utils.checkpoint import save_train_state

    dtype = getattr(torch, spec["dtype"])
    result = {{}}
    if mode == "train":
        # count -> allreduce -> data-parallel train/eval over a mesh of
        # 2 CPU entries per process (bear_tpu's 2 virtual devices per host)
        pairs = [(s, i % 2) for i, s in enumerate(spec["seqs"])]
        mine = multihost.host_shard(pairs)
        assert 0 < len(mine) < len(pairs)
        tc = engine.TransitionCounter([3], n_groups=2, device="cpu")
        for chunk in engine.chunk_reads(((fastx.encode_seq(s), g) for s, g in mine), 3):
            tc.add_chunk(chunk)
        multihost.allreduce_tables(tc)
        ds = tc.to_dataset(3)
        mesh = data_parallel_mesh(2 * nproc, device="cpu")
        assert mesh.spans_processes and [i for i, _ in mesh.local_entries()] == [
            2 * pid, 2 * pid + 1]
        ar = get_ar_func("linear", 3, 4, dtype=dtype, device="cpu")
        res = bear_net.train(ds.codes, ds.counts[:, 0], len(ds.codes), ar, batch_size=64,
                             epochs=50, learning_rate=0.05, seed=11, mesh=mesh,
                             params_restart=spec["p0"], dtype=dtype, device="cpu")
        ev = bear_net.evaluation(ds.codes, ds.counts, 0, 1, "dna", res.h, ar,
                                 res.params_list[1:], [1.0], mesh=mesh, dtype=dtype,
                                 device="cpu")
        result = dict(elbos=res.elbos, ev=np.array([float(np.asarray(e).reshape(-1)[0])
                                                    for e in ev]),
                      **{{f"p{{i}}": p for i, p in enumerate(res.params_list)}})
    elif mode in ("shared", "diverged"):
        rng = np.random.default_rng(7)
        n, lag, bsz = 64, 3, 8
        codes = rng.integers(0, 4, (n, lag)).astype(np.int8)
        counts = rng.poisson(4.0, (n, 5)).astype(np.float64)

        def shards():
            yield codes[:32], counts[:32]
            yield codes[32:], counts[32:]

        mesh = data_parallel_mesh(device="cpu")
        ar = get_ar_func("linear", lag, 4, dtype=dtype, device="cpu")
        kw = dict(num_kmers=n, ar_func=ar, batch_size=bsz, epochs=2, learning_rate=0.02,
                  seed=0, dtype=dtype, block_steps=2, mesh=mesh, device="cpu",
                  params_restart=spec["p0"])
        if mode == "diverged":
            # rank-local directories: rank 0 holds a mid-run state, rank 1
            # nothing -> the resume check must abort BOTH ranks
            my_dir = os.path.join(spec["ckdir"], f"rank{{pid}}")
            os.makedirs(my_dir, exist_ok=True)
            if pid == 0:
                save_train_state(my_dir, {{
                    "params": spec["p0"], "applies_done": 4,
                    "torch_opt_state": {{"name": "adam", "step": 0, "exp_avg": [],
                                         "exp_avg_sq": []}}}})
            try:
                bear_net.train_streaming(shards, checkpoint_dir=my_dir, **kw)
            except RuntimeError as e:
                assert "differs across processes" in str(e), e
                result = dict(aborted=np.array(1))
            else:
                raise AssertionError("the diverged resume was not detected")
        else:
            res = bear_net.train_streaming(shards, checkpoint_dir=spec["ckdir"], **kw)
            again = bear_net.train_streaming(shards, checkpoint_dir=spec["ckdir"], **kw)
            for a, b in zip(res.params_list, again.params_list):
                np.testing.assert_array_equal(a, b)
            assert len(again.elbos) == 0
            result = dict(elbos=res.elbos,
                          **{{f"p{{i}}": p for i, p in enumerate(res.params_list)}})
    elif mode == "serve":
        # a table row-split over 2 slices per process
        table = np.asarray(spec["table"], np.float64)
        mesh = grid_mesh({{"kmer": 2 * nproc}}, device="cpu")
        server = BearServer(table, 3, van=0.5, dtype=dtype, device="cpu", mesh=mesh)
        assert len(server._slices) == 2
        seqs = spec["seqs"]
        result = dict(
            map=server.score(seqs),
            sampled=server.score(seqs, mode="sample", key=kr.key(3), mc_samples=4),
            snv=server.delta_scores_snv(seqs[0], [1, 4], ["A", "C"], mode="sample",
                                        key=kr.key(5), mc_samples=3))
    np.savez(out, **result)
    torch.distributed.destroy_process_group()
    print(f"proc {{pid}} OK")
    """
).format(repo=REPO)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, spec, nproc=2, timeout=120, script=WORKER):
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps({**spec, "nproc": nproc}))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(spec_path), str(i), str(port),
                               str(tmp_path / f"rank{i}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for i in range(nproc)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:  # no orphaned workers on a timeout
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "OK" in out, out
    return [np.load(tmp_path / f"rank{i}.npz") for i in range(nproc)]


@pytest.mark.skipif(sys.platform != "linux", reason="process test, linux only")
@pytest.mark.parametrize("mode", list(CASES))
def test_two_process_allreduce_equals_bear_tpu(tmp_path, mode):
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(10, 45, 9)]
    lags = CASES[mode]
    ranks = _run_workers(tmp_path, {"mode": mode, "lags": lags, "seqs": seqs})
    # bear_tpu's single-process count of every read
    ref = (JSparse if mode == "sparse_first" else JCounter)(lags=lags, n_groups=2)
    enc = ((jfastx.encode_seq(s), i % 2) for i, s in enumerate(seqs))
    for chunk in jchunk_reads(enc, max(lags), batch_size=3):
        ref.add_chunk(chunk)
    transitions = sum(len(s) + 1 for s in seqs)
    for got in ranks:
        np.testing.assert_array_equal(got["total"], [transitions, 2 * 2**40 + 1])
        for when in ("once", "twice"):
            for l in lags:
                if mode in ("row_split", "sparse_first"):
                    jk, jv = (ref._consolidated(l) if mode == "sparse_first" else (
                        np.flatnonzero(ref.tables[l]), ref.tables[l].ravel()[
                            np.flatnonzero(ref.tables[l])]))
                    np.testing.assert_array_equal(got[f"{when}_keys_{l}"], jk)
                    np.testing.assert_array_equal(got[f"{when}_vals_{l}"], jv)
                else:
                    np.testing.assert_array_equal(got[f"{when}_table_{l}"], ref.tables[l])


def test_single_process_is_a_no_op():
    # No coordinator and no auto-detection: one process, nothing to merge
    # (bear_tpu's initialize returns the same way).
    import torch.distributed as dist

    from bear_tpu_torch.counting import engine, fastx
    from bear_tpu_torch.parallel import multihost

    multihost.initialize()
    assert not dist.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.host_shard(list("abcde")) == list("abcde")
    assert multihost.host_shard(list("abcde"), process_id=1, process_count=2) == ["b", "d"]
    arr = np.array([1, 2**40], np.int64)
    out = multihost.allreduce_sum_i64(arr)
    np.testing.assert_array_equal(out, arr)
    assert out is not arr
    tc = engine.TransitionCounter([2], device="cpu")
    for chunk in engine.chunk_reads(iter([(fastx.encode_seq("ACGTAC"), 0)]), 2):
        tc.add_chunk(chunk)
    before = tc.tables[2].copy()
    multihost.allreduce_tables(tc)
    np.testing.assert_array_equal(tc.tables[2], before)


def _train_seqs():
    rng = np.random.default_rng(7)
    return ["".join(rng.choice(list("ACGT"), size=rng.integers(15, 30))) for _ in range(40)]


@pytest.mark.skipif(sys.platform != "linux", reason="process test, linux only")
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_process_training(tmp_path, dtype):
    # tests/test_multihost.py:248: count -> allreduce -> data-parallel
    # train/eval over a mesh spanning both processes: both ranks bit-equal,
    # and equal to bear_tpu's single-process run of the same protocol
    # (float64 at the port's trajectory tolerance, float32 at bear_tpu's
    # own 5e-3).
    seqs = _train_seqs()
    jar = jget_ar_func("linear", 3, 4, dtype=getattr(jnp, dtype))
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(11), jar, dtype=getattr(jnp, dtype)))
    ranks = _run_workers(tmp_path, {"mode": "train", "dtype": dtype, "seqs": seqs,
                                    "p0": [np.asarray(p).tolist() for p in p0]},
                         script=MESH_WORKER)
    keys = sorted(ranks[0].files)
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    tc = JCounter(lags=[3], n_groups=2)
    for chunk in jchunk_reads(((jfastx.encode_seq(s), i % 2) for i, s in enumerate(seqs)), 3):
        tc.add_chunk(chunk)
    ds = tc.to_dataset(3)
    jdt = getattr(jnp, dtype)
    res = jbn.train(ds.codes, ds.counts[:, 0].astype(np.dtype(dtype)), len(ds.codes), jar,
                    batch_size=64, epochs=50, learning_rate=0.05, seed=11, params_restart=p0,
                    dtype=jdt)
    ev = jbn.evaluation(ds.codes, ds.counts.astype(np.dtype(dtype)), 0, 1, "dna", res.h, jar,
                        [np.asarray(p) for p in res.params["ar"]],
                        np.array([1.0], np.dtype(dtype)), dtype=jdt)
    rtol = 1e-8 if dtype == "float64" else 5e-3
    got = ranks[0]
    np.testing.assert_allclose(got["elbos"], np.asarray(res.elbos), rtol=rtol)
    np.testing.assert_allclose(np.exp(got["p0"]), res.h, rtol=rtol)
    want_ev = [float(np.asarray(e).reshape(-1)[0]) for e in ev]
    np.testing.assert_allclose(got["ev"][:6], want_ev[:6], rtol=rtol)


@pytest.mark.skipif(sys.platform != "linux", reason="process test, linux only")
@pytest.mark.parametrize("mode", ["shared", "diverged"])
def test_two_process_streaming_checkpoint(tmp_path, mode):
    # tests/test_multihost.py:445: a SHARED checkpoint directory trains,
    # checkpoints (rank 0 alone writes) and resumes identically on every
    # rank; rank-LOCAL directories with diverged state abort both ranks.
    jar = jget_ar_func("linear", 3, 4, dtype=jnp.float64)
    p0 = jbn.params_to_list(jbn.init_params(jax.random.key(0), jar, dtype=jnp.float64))
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    ranks = _run_workers(tmp_path, {"mode": mode, "dtype": "float64", "ckdir": str(ckdir),
                                    "p0": [np.asarray(p).tolist() for p in p0]},
                         script=MESH_WORKER)
    if mode == "diverged":
        assert all(int(r["aborted"]) == 1 for r in ranks)
        return
    for k in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    assert sorted(os.listdir(ckdir)) == ["train_state.pickle"]  # rank 0's alone


@pytest.mark.skipif(sys.platform != "linux", reason="process test, linux only")
def test_two_process_row_split_server(tmp_path):
    # A table row-split over 4 slices, two in each process: MAP, sampled
    # and SNV draws equal the dense table's exactly on both ranks; MAP
    # equals bear_tpu's dense server.
    import torch

    from bear_tpu_torch.counting.engine import table_rows
    from bear_tpu_torch.inference.serving import BearServer
    from bear_tpu_torch.ops import keyed_random as kr

    rng = np.random.default_rng(2)
    table = rng.poisson(0.6, (table_rows(3), 5)).astype(np.float64)
    seqs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(8, 40, 12)]
    ranks = _run_workers(tmp_path, {"mode": "serve", "dtype": "float64",
                                    "table": table.tolist(), "seqs": seqs},
                         script=MESH_WORKER)
    dense = BearServer(table, 3, van=0.5, dtype=torch.float64, device="cpu")
    want = dict(map=dense.score(seqs),
                sampled=dense.score(seqs, mode="sample", key=kr.key(3), mc_samples=4),
                snv=dense.delta_scores_snv(seqs[0], [1, 4], ["A", "C"], mode="sample",
                                           key=kr.key(5), mc_samples=3))
    for got in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
    jmap = np.asarray(JServer(table, 3, van=0.5, dtype=jnp.float64).score(seqs, mode="map"))
    np.testing.assert_allclose(ranks[0]["map"], jmap, rtol=1e-10)
