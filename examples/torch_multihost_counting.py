"""Multi-process streamed k-mer counting harness on the PyTorch port
(bear_tpu_torch), the processes joined by torch.distributed's gloo backend.

- each process streams its shard of the input FILES (multihost.host_shard),
- counts locally on its card (TransitionCounter: the count_chunk kernel, as
  on the one-card path) or, with --device cpu, on the CPU,
- merges exact global tables with one int64 all-reduce per lag
  (multihost.allreduce_tables),
- checks conservation of the global transition count on every rank, and
  rank 0 reports aggregate throughput.

Run (one machine, N processes standing in for N hosts; process r takes
card r % device_count, so processes share a card when there are fewer):

    python examples/torch_multihost_counting.py --nproc 2 --lag 5
    python examples/torch_multihost_counting.py --nproc 2 --lag 5 --device cpu

With --csv the harness counts your own FILE,GROUP,TYPE input set instead of
the synthetic reads (gzip inputs welcome).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

try:  # run as a script (python examples/torch_multihost_counting.py)
    from _common import REPO, free_port
except ImportError:  # imported as a package module (tests)
    from examples._common import REPO, free_port


def make_synthetic(workdir: str, n_files: int, reads_per_file: int,
                   read_len: int, seed: int = 0) -> str:
    """Write n_files synthetic fastqs + an input CSV; return the CSV path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    csv = os.path.join(workdir, "inputs.csv")
    with open(csv, "w") as out:
        for fi in range(n_files):
            path = os.path.join(workdir, f"reads_{fi}.fq")
            codes = rng.integers(0, 4, size=(reads_per_file, read_len))
            with open(path, "wb") as fh:
                qual = b"F" * read_len
                for ri, row in enumerate(lut[codes]):
                    fh.write(b"@r%d\n%s\n+\n%s\n" % (ri, row.tobytes(), qual))
            out.write(f"{path},{fi % 2},fq\n")  # two count groups
    return csv


def worker_env() -> dict:
    """Environment for a worker process: the repo replaces PYTHONPATH."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def process_device(device: str, pid: int):
    """This process's device: card pid % device_count, or the CPU."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", pid % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def worker(args) -> None:
    import numpy as np
    import torch

    from bear_tpu_torch.counting import TransitionCounter, fastx
    from bear_tpu_torch.counting.summarize import iter_chunks
    from bear_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=args.coordinator, num_processes=args.nproc,
                         process_id=args.pid, timeout_s=args.timeout)
    dev = process_device(args.device, args.pid)

    entries = fastx.read_input_csv(args.csv)
    mine = multihost.host_shard(entries)
    n_groups = max(group for _, group, _ in entries) + 1  # global, all ranks
    counter = TransitionCounter(lags=range(1, args.lag + 1), n_groups=n_groups, device=dev)
    stats = {"bases": 0, "reads": 0}
    t0 = time.time()
    for chunk in iter_chunks(mine, counter.max_lag, stats=stats):
        counter.add_chunk(chunk)
    counter.sync()
    count_s = time.time() - t0
    t0 = time.time()
    multihost.allreduce_tables(counter)
    merge_s = time.time() - t0

    # Count conservation: at every lag each read of length n emits n+1
    # transitions (n next-base + 1 stop), short reads included.
    g_bases, g_reads = multihost.allreduce_sum_i64([stats["bases"], stats["reads"]])
    expected = int(g_bases + g_reads)
    counter.validate(expected_transitions=expected)

    totals = {l: int(t.sum()) for l, t in counter.tables.items()}
    if args.bench:
        # Per-rank [bases, reads, seconds]: the float64 seconds travel as
        # their int64 bits, exact.
        mine_row = np.array([stats["bases"], stats["reads"], 0], np.int64)
        mine_row[2] = np.array([count_s], np.float64).view(np.int64)[0]
        per_rank = multihost.allgather_i64(mine_row).reshape(args.nproc, 3)
        seconds = per_rank[:, 2].copy().view(np.float64)
        rank_tps = [float((b + r) / max(t, 1e-9))
                    for (b, r), t in zip(per_rank[:, :2], seconds)]
        if args.pid == 0:
            line = "BENCH " + json.dumps({
                "bench": "multihost_counting",
                "hosts": args.nproc,
                "lags": f"1..{args.lag}",
                "global_transitions_per_lag": expected,
                "per_host_transitions_per_sec": [round(x) for x in rank_tps],
                "aggregate_transitions_per_sec": round(
                    float(per_rank[:, :2].sum()) / max(float(seconds.max()), 1e-9)),
                "per_host_bases": [int(b) for b in per_rank[:, 0]],
                "count_seconds": [round(float(t), 3) for t in seconds],
                "merge_seconds": round(merge_s, 3),
                "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu"),
            })
            # ONE write syscall incl. the newline: all ranks share stdout, and
            # print()'s separate payload/end writes let another rank's line
            # splice in between.
            sys.stdout.write(line + "\n")
            sys.stdout.flush()
    if args.pid == 0:
        print(f"[rank 0] hosts={args.nproc} lags=1..{args.lag} "
              f"global transitions={sum(totals.values())} "
              f"(= {expected}/lag, conservation verified)")
        print(f"[rank 0] local count {count_s:.2f}s, table merge {merge_s:.2f}s")
        print(f"[rank 0] local feed {stats['bases'] / max(count_s, 1e-9) / 1e6:.1f} "
              f"Mbases/s on {dev}; aggregate ~{args.nproc}x with balanced shards")
    sys.stdout.write(f"[rank {args.pid}] OK totals={totals}\n")
    sys.stdout.flush()
    torch.distributed.destroy_process_group()


def launch(args, workdir: str) -> int:
    csv = args.csv or make_synthetic(
        workdir, n_files=max(args.nproc * 2, 4),
        reads_per_file=args.reads_per_file, read_len=args.read_len)
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--csv", csv, "--lag", str(args.lag), "--nproc", str(args.nproc),
           "--coordinator", f"127.0.0.1:{port}", "--device", args.device,
           "--timeout", str(args.timeout)]
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
    # signal-killed workers have NEGATIVE returncodes; any nonzero is failure
    return 0 if all(c == 0 for c in codes) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2,
                    help="number of host processes to launch")
    ap.add_argument("--lag", type=int, default=5)
    ap.add_argument("--csv", default=None,
                    help="FILE,GROUP,TYPE input csv (default: synthetic reads)")
    ap.add_argument("--reads-per-file", type=int, default=20000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--workdir", default=None,
                    help="where the synthetic reads go (default: a temporary directory, "
                         "removed afterwards)")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds the workers, their rendezvous and each collective may take")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="count on each process's card (default) or on the CPU")
    ap.add_argument("--bench", action="store_true",
                    help="emit one 'BENCH {json}' line from rank 0 with "
                         "per-host and aggregate transitions/s")
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
    with tempfile.TemporaryDirectory(prefix="bear_mh_") as workdir:
        return launch(args, workdir)


if __name__ == "__main__":
    sys.exit(main())
