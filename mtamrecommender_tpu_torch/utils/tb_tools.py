"""TensorBoard run tooling (twin of mtamrecommender_tpu/utils/tb_tools.py):
the reference's `run_tensorboard.py` and `compress.py`.

`archive_runs` writes each run directory under ``data/runs/<name>`` as a
``<name>.tar.xz``; `extract_archives` unpacks them back into the run
root; `launch_tensorboard` starts one tensorboard process for a run
directory on a free local port (9020-9039).  Pure Python: no torch.
"""

from __future__ import annotations

import glob
import os
import socket
import subprocess
import tarfile
from typing import List, Optional, Tuple


def archive_runs(run_root: str = "data/runs",
                 out_dir: str = "data/tensorboard_compress",
                 pattern: str = "*") -> List[str]:
    """tar.xz every run directory under ``run_root`` matching
    ``pattern``; returns the archives' paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for run_dir in sorted(glob.glob(os.path.join(run_root, pattern))):
        if not os.path.isdir(run_dir):
            continue
        name = os.path.basename(run_dir.rstrip("/"))
        out_path = os.path.join(out_dir, f"{name}.tar.xz")
        with tarfile.open(out_path, "w:xz") as tar:
            tar.add(run_dir, arcname=name)
        written.append(out_path)
    return written


def extract_archives(archive_dir: str = "data/tensorboard_compress",
                     out_root: str = "data/runs") -> List[str]:
    """Unpack every ``*.tar.xz`` under ``archive_dir`` into ``out_root``;
    returns the archives' paths."""
    extracted = []
    for path in sorted(glob.glob(os.path.join(archive_dir, "*.tar.xz"))):
        with tarfile.open(path, "r:xz") as tar:
            tar.extractall(out_root, filter="data")
        extracted.append(path)
    return extracted


def _free_port(start: int = 9020, end: int = 9040) -> int:
    for port in range(start, end):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
                return port
            except OSError:
                continue
    raise RuntimeError(f"no free port in [{start}, {end})")


def launch_tensorboard(run_dir: str, port: Optional[int] = None
                       ) -> Tuple[subprocess.Popen, int]:
    """Start one tensorboard for ``run_dir``; returns (process, port)."""
    port = port or _free_port()
    proc = subprocess.Popen(
        ["tensorboard", "--logdir", run_dir, "--port", str(port),
         "--bind_all"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, port
