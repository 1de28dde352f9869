"""Build and load the port's CUDA kernels.

Each source under ``mtamrecommender_tpu_torch/csrc/`` compiles with nvcc
into its own shared library with a plain C interface, loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/lib<name>-<hash>.so <name>.cu

Libraries go to ``build/torch_kernels/`` at the repository root (listed
in .gitignore), named by a hash of the sources, so an edited source
rebuilds and an unchanged one loads what is there.  Nothing is built when
a module is imported: a wrapper builds its library at its first launch,
and `build` builds several at once, one nvcc process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# kernel library name -> its source file; every source includes common.cuh
# (the readouts' four include readout_hop.cuh; fused_readout.cu and
# fused_readout_bwd.cu also readout_gemm.cuh, which includes tile_gemm.cuh;
# fused_attention_tile.cu and fused_attention_bwd_tile.cu include
# attention_tile.cuh, which includes tile_gemm.cuh; fused_attention_wide.cu
# and fused_attention_bwd_wide.cu include attention_wide.cuh, which
# includes attention_tile.cuh; readout_chain.cu, readout_chain_bwd.cu,
# fused_attention_hop.cu and fused_attention_blocked.cu include
# chain_staged.cuh, which includes readout_hop.cuh)
SOURCES = {"gru_scan": "gru_scan.cu", "gru_scan_bwd": "gru_scan_bwd.cu",
           "fused_attention": "fused_attention.cu",
           "fused_attention_tile": "fused_attention_tile.cu",
           "fused_attention_hop": "fused_attention_hop.cu",
           "fused_attention_blocked": "fused_attention_blocked.cu",
           "fused_attention_bwd": "fused_attention_bwd.cu",
           "fused_attention_bwd_tile": "fused_attention_bwd_tile.cu",
           "fused_attention_wide": "fused_attention_wide.cu",
           "fused_attention_bwd_wide": "fused_attention_bwd_wide.cu",
           "fused_attention_blockwise": "fused_attention_blockwise.cu",
           "embedding_dtable": "embedding_dtable.cu",
           "embedding_gather": "embedding_gather.cu",
           "fused_readout": "fused_readout.cu",
           "fused_readout_bwd": "fused_readout_bwd.cu",
           "readout_chain": "readout_chain.cu",
           "readout_chain_bwd": "readout_chain_bwd.cu"}
_HEADERS = ("common.cuh", "readout_hop.cuh", "readout_gemm.cuh",
            "tile_gemm.cuh", "attention_tile.cuh", "attention_wide.cuh",
            "chain_staged.cuh")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + _HEADERS:
        digest.update((CSRC_DIR / fname).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (all by default) that are not built
    yet, one nvcc process per source, all started together.  Returns
    {name: {"path", "seconds", "log"}}; raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    report = {name: {"path": str(library_path(name)), "seconds": 0.0,
                     "log": "already built"} for name in names}
    failures = []
    try:
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
            report[name] = {"path": str(out), "seconds": seconds, "log": log}
    finally:
        for proc, tmp, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.port_error_string.argtypes = [ctypes.c_int]
            lib.port_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if status != 0:
        msg = lib.port_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def launch_context(tensors, what: str):
    """Checks every launch shares: all tensors on one CUDA device,
    contiguous, and not tracked by autograd.  A kernel with a backward
    runs inside its autograd.Function, where grad mode is off; a kernel
    called with grad mode on and an operand that requires grad would
    return a result without a gradient, so it raises.  Returns (device
    index, current stream handle) for the C interface."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: tensors on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: every operand must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel returns no gradient; call it under "
            "torch.no_grad() or through its autograd function (gru_scan: "
            "gru_scan_vjp; fused_attention: fused_attention_vjp; "
            "fused_readout: fused_readout_vjp; readout_chain: "
            "readout_chain_vjp; gather: embedding_kernel.gather)")
    # the current stream's handle (what torch.cuda.current_stream(device)
    # .cuda_stream gives, without building a Stream object each launch)
    return device.index, torch._C._cuda_getCurrentRawStream(device.index)
