"""Multi-process end-to-end BEAR training harness on the PyTorch port
(bear_tpu_torch), the processes joined by torch.distributed's gloo backend.

- each process streams and counts its shard of the input files on its card
  (multihost.host_shard + TransitionCounter),
- the exact global count tables are merged once with an int64 all-reduce
  (multihost.allreduce_tables): every process then holds the whole
  dataset (small by design: BEAR collapses genomes to k-mer statistics),
- a linear BEAR trains data-parallel over a mesh with one entry per
  process, its card (bear_net.train(mesh=...); the gradients are summed
  over the group each apply), or with --device cpu two CPU entries per
  process,
- evaluation runs over the same mesh, and every rank must have learned
  the same h to the bit (the program is identical on every process).

Run (one machine, N processes standing in for N hosts; process r takes
card r % device_count, so processes share a card when there are fewer):

    python examples/torch_multihost_train.py --nproc 2 --lag 5
    python examples/torch_multihost_train.py --nproc 2 --lag 5 --streaming --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

try:  # run as a script (python examples/torch_multihost_train.py)
    from _common import free_port
    from torch_multihost_counting import process_device, worker_env
except ImportError:  # imported as a package module (tests)
    from examples._common import free_port
    from examples.torch_multihost_counting import process_device, worker_env

CPU_ENTRIES = 2  # mesh entries per process with --device cpu


def make_synthetic(workdir: str, n_files: int, reads_per_file: int,
                   read_len: int, seed: int = 0) -> str:
    """Write n_files synthetic fastqs + an input CSV; return the CSV path.

    Groups alternate per file: group 0 is the training column, group 1 the
    held-out test column (the reference's train/test count-column layout,
    train_bear_net.py:49-56).
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    # A biased source so there is structure to learn: AR(1)-ish transitions.
    trans = rng.dirichlet(np.full(4, 0.5), size=4)
    cum = np.cumsum(trans, axis=1)  # [4, 4] cumulative rows
    csv = os.path.join(workdir, "inputs.csv")
    with open(csv, "w") as out:
        for fi in range(n_files):
            path = os.path.join(workdir, f"reads_{fi}.fq")
            # Vectorized Markov rollout across all reads of the file: one
            # uniform draw per base, advanced per position via the
            # cumulative transition rows.
            u = rng.random((reads_per_file, read_len))
            codes = np.empty((reads_per_file, read_len), np.int64)
            codes[:, 0] = rng.integers(0, 4, size=reads_per_file)
            for j in range(1, read_len):
                codes[:, j] = (u[:, j:j + 1] > cum[codes[:, j - 1]]).sum(1)
            with open(path, "wb") as fh:
                qual = b"F" * read_len
                for ri, row in enumerate(lut[codes]):
                    fh.write(b"@r%d\n%s\n+\n%s\n" % (ri, row.tobytes(), qual))
            out.write(f"{path},{fi % 2},fq\n")
    return csv


def process_mesh(dev, nproc: int):
    """The data mesh over every process: its card (one entry each), or
    CPU_ENTRIES entries of the CPU each."""
    import torch

    from bear_tpu_torch.parallel import Mesh, data_parallel_mesh

    if dev.type == "cpu":
        return data_parallel_mesh(CPU_ENTRIES * nproc, device="cpu")
    count = torch.cuda.device_count()
    return Mesh([torch.device("cuda", r % count) for r in range(nproc)], ("data",),
                processes=list(range(nproc)))


def worker(args) -> None:
    import numpy as np
    import torch

    from bear_tpu_torch.counting import TransitionCounter, fastx
    from bear_tpu_torch.counting.summarize import iter_chunks
    from bear_tpu_torch.models import bear_net, get_ar_func
    from bear_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=args.coordinator, num_processes=args.nproc,
                         process_id=args.pid, timeout_s=args.timeout)
    dev = process_device(args.device, args.pid)

    # ---- count locally, merge globally -------------------------------
    entries = fastx.read_input_csv(args.csv)
    mine = multihost.host_shard(entries)
    n_groups = max(group for _, group, _ in entries) + 1
    counter = TransitionCounter(lags=[args.lag], n_groups=n_groups, device=dev)
    t0 = time.time()
    for chunk in iter_chunks(mine, counter.max_lag):
        counter.add_chunk(chunk)
    multihost.allreduce_tables(counter)
    count_s = time.time() - t0
    ds = counter.to_dataset(args.lag)

    # ---- train data-parallel over the mesh of every process -----------
    mesh = process_mesh(dev, args.nproc)
    ar = get_ar_func("linear", args.lag, 4, device=dev)
    t0 = time.time()
    if args.streaming:
        # Streaming + data parallelism: batches flow through fixed-geometry
        # blocks, each split over the mesh. Here the stream is row ranges of
        # the merged table; in a beyond-RAM run it would be per-file count
        # shards.
        n = len(ds.codes)
        shard_rows = max(args.batch_size, -(-n // 8))

        def shards():
            for s0 in range(0, n, shard_rows):
                yield (ds.codes[s0:s0 + shard_rows],
                       ds.counts[s0:s0 + shard_rows, 0].astype(np.float32))

        res = bear_net.train_streaming(
            shards, n, ar, batch_size=args.batch_size, epochs=args.epochs,
            learning_rate=0.01, seed=args.seed, mesh=mesh, block_steps=16, device=dev,
        )
    else:
        res = bear_net.train(
            ds.codes, ds.counts[:, 0].astype(np.float32), len(ds.codes), ar,
            batch_size=args.batch_size, epochs=args.epochs,
            learning_rate=0.01, seed=args.seed, mesh=mesh, device=dev,
        )
    train_s = time.time() - t0
    # With a single count group (e.g. a user CSV where every file is group 0)
    # there is no held-out column: evaluate the training column in prior mode
    # (ds_loc_train=-1, the reference's train_test protocol) and say so.
    heldout = n_groups > 1
    ev = bear_net.evaluation(
        ds.codes, ds.counts.astype(np.float32),
        0 if heldout else -1, 1 if heldout else 0, "dna",
        res.h, ar, res.params["ar"], np.array([1.0], np.float32), mesh=mesh, device=dev,
    )
    perp_bear = float(np.asarray(ev[3]))
    perp_label = "heldout" if heldout else "train-as-test (prior)"

    # ---- every rank must have learned the identical model ------------
    h_bits = multihost.allgather_i64(np.array([res.h], np.float64).view(np.int64))
    if not np.all(h_bits == h_bits[0]):
        raise RuntimeError(f"rank h mismatch: {h_bits.view(np.float64)}")

    if args.bench and args.pid == 0:
        steps = len(res.losses)
        line = "BENCH " + json.dumps({
            "bench": "multihost_train",
            "hosts": args.nproc,
            "devices": mesh.size,
            "lag": args.lag,
            "kmers": len(ds.codes),
            "streaming": bool(args.streaming),
            "count_merge_seconds": round(count_s, 3),
            "train_seconds": round(train_s, 3),
            "steps_per_sec": round(steps / max(train_s, 1e-9), 2),
            "kmers_per_sec": round(steps * args.batch_size / max(train_s, 1e-9)),
            "h": float(res.h),
            "bear_perplexity": perp_bear,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        })
        # ONE write syscall incl. the newline: all ranks share stdout, and
        # print()'s separate payload/end writes let another rank's line
        # splice in between.
        sys.stdout.write(line + "\n")
        sys.stdout.flush()
    if args.pid == 0:  # each line one write, as the BENCH line
        sys.stdout.write(f"[rank 0] hosts={args.nproc} devices={mesh.size} "
                         f"lag={args.lag} kmers={len(ds.codes)}\n")
        sys.stdout.write(f"[rank 0] count+merge {count_s:.2f}s, train {train_s:.2f}s "
                         f"({len(res.losses) / max(train_s, 1e-9):.0f} steps/s)\n")
        sys.stdout.write(f"[rank 0] learned h={res.h:.5f} {perp_label} BEAR perplexity="
                         f"{perp_bear:.4f}; h identical on all {args.nproc} ranks\n")
    sys.stdout.write(f"[rank {args.pid}] OK h={res.h!r}\n")
    sys.stdout.flush()
    torch.distributed.destroy_process_group()


def launch(args, workdir: str) -> int:
    csv = args.csv or make_synthetic(
        workdir, n_files=max(args.nproc * 2, 4),
        reads_per_file=args.reads_per_file, read_len=args.read_len)
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--csv", csv, "--lag", str(args.lag), "--nproc", str(args.nproc),
           "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
           "--seed", str(args.seed), "--coordinator", f"127.0.0.1:{port}",
           "--device", args.device, "--timeout", str(args.timeout)]
    if args.streaming:
        cmd.append("--streaming")
    if args.bench:
        cmd.append("--bench")
    env = worker_env()
    procs = [subprocess.Popen(cmd + ["--pid", str(i)], env=env)
             for i in range(args.nproc)]
    try:
        codes = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if all(c == 0 for c in codes) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2,
                    help="number of host processes to launch")
    ap.add_argument("--lag", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--csv", default=None,
                    help="FILE,GROUP,TYPE input csv (default: synthetic reads)")
    ap.add_argument("--reads-per-file", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--workdir", default=None,
                    help="where the synthetic reads go (default: a temporary directory, "
                         "removed afterwards)")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds the workers, their rendezvous and each collective may take")
    ap.add_argument("--streaming", action="store_true",
                    help="train via bear_net.train_streaming(mesh=...): "
                         "shard-streamed batches over the mesh, device memory "
                         "bounded by one block")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="count and train on each process's card (default) or on the CPU")
    ap.add_argument("--bench", action="store_true",
                    help="emit one 'BENCH {json}' line from rank 0 with "
                         "count/merge/train timings and steps/s")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        return launch(args, args.workdir)
    with tempfile.TemporaryDirectory(prefix="bear_mht_") as workdir:
        return launch(args, workdir)


if __name__ == "__main__":
    sys.exit(main())
