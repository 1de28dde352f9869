"""Experiment-fleet driver — the `run_server.py` equivalent (the
counterpart of mtamrecommender_tpu/fleet.py).

The reference greedily assigns GPU slots and forks
`nohup python3 train_process.py ... &` per (dataset x model) combination
(`run_server.py:46-100`).  This driver launches one
``python -m mtamrecommender_tpu_torch`` subprocess per experiment over a
work queue with bounded concurrency (one card runs one experiment at a
time by default), the same per-model batch-size table
(run_server.py:18-40), and per-run log capture instead of nohup spray.
A failed run is retried with ``train.load_type=full``: it resumes from
its latest checkpoint.  ``--device`` (default cuda) is passed on.

    python -m mtamrecommender_tpu_torch.fleet --datasets synthetic \\
        --models MTAM Gru4Rec SASrec --max_steps 200
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

# per-model train batch sizes (run_server.py:18-40)
BATCH_SIZE_TABLE: Dict[str, int] = {
    "SASrec": 256, "Time_Aware_Self_Attention_Model": 256,
    "Ti_Self_Attention_Model": 256, "MTAM": 256, "Gru4Rec": 256,
    "T_SeqRec": 256, "NARM": 256, "STAMP": 256, "LSTUR": 256, "bpr": 512,
}


def launch(dataset: str, model: str, extra: List[str], run_root: str,
           log_dir: str, version: str, resume: bool = False,
           device: str = "cuda") -> subprocess.Popen:
    os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "mtamrecommender_tpu_torch",
           "--type", dataset, "--experiment_type", model,
           "--version", version, "--run_root", run_root, "--device", device]
    if model in BATCH_SIZE_TABLE:
        cmd += ["--train_batch_size", str(BATCH_SIZE_TABLE[model])]
    if resume:
        # elastic recovery: restore the run's latest checkpoint and its
        # data cursor (exact resume, train/checkpoint.py); the version
        # stays the same so the checkpoint dir matches
        cmd += ["--set", "train.load_type=full"]
    cmd += extra
    log_path = os.path.join(log_dir, f"{dataset}_{model}.log")
    log_file = open(log_path, "a" if resume else "w")
    return subprocess.Popen(cmd, stdout=log_file, stderr=subprocess.STDOUT)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="mtamrecommender_tpu_torch.fleet")
    p.add_argument("--datasets", nargs="+", default=["synthetic"])
    p.add_argument("--models", nargs="+", default=["MTAM"])
    p.add_argument("--concurrency", type=int, default=1,
                   help="simultaneous experiments (1 per card)")
    p.add_argument("--run_root", default="data/runs")
    p.add_argument("--log_dir", default="data/log_data/fleet")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--retries", type=int, default=1,
                   help="per-experiment retries; a retry resumes from the "
                        "run's latest checkpoint (load_type=full)")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="passed to each run (default cuda)")
    args = p.parse_args(argv)

    extra: List[str] = []
    if args.max_steps is not None:
        extra += ["--max_steps", str(args.max_steps)]
    if args.max_epochs is not None:
        extra += ["--max_epochs", str(args.max_epochs)]
    for s in args.set:
        extra += ["--set", s]

    stamp = int(time.time())
    queue = [(d, m, 0) for d in args.datasets for m in args.models]
    running: List = []
    failures = 0
    while queue or running:
        while queue and len(running) < args.concurrency:
            dataset, model, attempt = queue.pop(0)
            version = f"fleet_{stamp}"
            proc = launch(dataset, model, extra, args.run_root,
                          args.log_dir, version, resume=attempt > 0,
                          device=args.device)
            print(f"[fleet] started {dataset}/{model} (pid {proc.pid}"
                  + (f", resume attempt {attempt}" if attempt else "") + ")")
            running.append((dataset, model, attempt, proc))
        time.sleep(1.0)
        still = []
        for dataset, model, attempt, proc in running:
            code = proc.poll()
            if code is None:
                still.append((dataset, model, attempt, proc))
            elif code != 0 and attempt < args.retries:
                print(f"[fleet] {dataset}/{model} FAILED rc={code}; "
                      f"re-enqueueing with checkpoint resume")
                queue.append((dataset, model, attempt + 1))
            else:
                status = "ok" if code == 0 else f"FAILED rc={code}"
                print(f"[fleet] finished {dataset}/{model}: {status}")
                failures += int(code != 0)
        running = still
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
