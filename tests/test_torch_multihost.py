"""The port's multi-process merge (bear_tpu_torch.parallel.multihost) in real
processes: two gloo processes each count their host_shard of the reads and
merge with allreduce_tables; every rank's tables must equal bear_tpu's
single-process count of all the reads, and a repeated merge must change
nothing. The counterparts of tests/test_multihost.py's counting tests.

The workers import only the port (no JAX); each has a timeout, and the
group's own timeout fails a lost peer within a minute.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from bear_tpu.counting import TransitionCounter as JCounter
from bear_tpu.counting import chunk_reads as jchunk_reads
from bear_tpu.counting import fastx as jfastx
from bear_tpu.counting.sparse import SparseTransitionCounter as JSparse

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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, spec, nproc=2, timeout=120):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
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
