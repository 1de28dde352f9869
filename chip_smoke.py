#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (mtamrecommender_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. card and build: the nvidia-smi name and power limit, then every
     kernel built from csrc/ (one nvcc per source, all at once);
  2. kernels against their plain PyTorch twins on the card, at the
     shapes the serving path gives them (B = 1, 16, 256, L=50,
     u=d=128; attention Tk=50 and Tk=1024), in f32 and bf16, with, at
     B=256, the kernel's time, the twin's time, the least time the card
     could take (bound) and, where one PyTorch call computes the same
     function, that call's time;
  3. the slice: Recommender.recommend at full width (MTAM d=128, 3
     hops, L=50, the ml-1m catalog, k=50) for B = 1, 16, 256 in bf16 and
     f32 compute, with launch counts per scoring call, scores held
     against the same Recommender on the CPU (the plain twins), and the
     time per request batch.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  A full report is written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 FMA units; bf16 tensor cores
# kernel vs plain twin on the card: max |diff| / max |output|
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# card vs CPU scores: max |diff| / max |score| over the catalog
SLICE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

DEVICE = "cuda"

GRU_REPLACES = "mtamrecommender_tpu/ops/pallas/gru_kernel.py:64"
ATT_REPLACES = "mtamrecommender_tpu/ops/pallas/attention_kernel.py:60"
GRU_SOURCE = "mtamrecommender_tpu_torch/csrc/gru_scan.cu"
ATT_SOURCE = "mtamrecommender_tpu_torch/csrc/fused_attention.cu"


def make_histories(rng, n, items, cats, max_len):
    """Synthetic (item, category, unix_seconds) histories of 5..max_len-1
    events (the generator of benchmarks/serve_bench.py)."""
    out = []
    base = 1_700_000_000
    for _ in range(n):
        hist_len = int(rng.randint(5, max_len))
        t = base + np.cumsum(rng.randint(60, 86400, hist_len))
        out.append([(int(rng.randint(1, items + 1)),
                     int(rng.randint(1, cats + 1)), float(tt))
                    for tt in t])
    return out, [float(t[-1] + 3600)] * n


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


class Timer:
    """Mean ms per call from CUDA events, each call after an L2 flush
    (the 50 MB L2 would otherwise hold the inputs between calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def rel_err(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


# ------------------------------------------------------------ phase 2

def gru_inputs(torch, gen, mode, dtype, B=256, L=50, u=128):
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    lengths = torch.randint(0, L + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, L], dtype=torch.int32)[:B]
    return (rand(B, L, 2 * u, scale=0.8), rand(B, L, u, scale=0.8),
            rand(B, L, u, scale=0.5), rand(B, L, u, scale=0.5).abs(),
            lengths, rand(B, u, scale=0.5),
            rand(u, 2 * u, scale=1 / math.sqrt(u)),
            rand(u, u, scale=1 / math.sqrt(u)),
            rand(2 * u, scale=0.1), rand(u, scale=0.1),
            rand(4, u, scale=0.5))


def gru_bound(mode, args, dtype_name):
    """Least time for the work these inputs need: alive steps' inputs read
    once, the weights and h0 read once, the whole output written once,
    and 2*u*3u FLOPs per alive step."""
    gx, lengths = args[0], args[4]
    B, L, u2 = gx.shape
    u = u2 // 2
    es = gx.element_size()
    steps = int(lengths.clamp(0, L).sum().item())
    per_step = (2 * u + u + (0 if mode == "plain" else 2 * u)) * es
    nbytes = (steps * per_step + B * 4 + B * u * es + 3 * u * u * es
              + 7 * u * es + B * L * u * 4)
    flops = steps * 2 * u * 3 * u
    return _bound(nbytes, flops, dtype_name)


def att_inputs(torch, gen, dtype, B=256, Tq=1, Tk=50, d=128):
    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=DEVICE) * scale
                ).to(dtype)
    hours = 470_000.0 + torch.rand(B, Tk, generator=gen, device=DEVICE) * 5000
    t_k = hours.sort(dim=1).values.to(dtype)
    t_q = (hours.max(dim=1, keepdim=True).values + 1.0).to(dtype)
    key_len = torch.randint(1, Tk + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    key_len[:2] = torch.tensor([0, Tk], dtype=torch.int32)[:B]
    gate = [rand(Tq, Tk, scale=0.3) for _ in range(5)]
    return (rand(B, Tq, d).relu(), rand(B, Tk, d).relu(), rand(B, Tk, d).relu(),
            t_q, t_k, rand(B, Tq, d, scale=0.3), rand(B, Tk, d), *gate,
            key_len)


def att_bound(mode, args, dtype_name):
    """Least time: q (and tqw, t_q) read once; for each live key its k
    row (and rawk row, t_k) and its v row read once (all Tk v rows for a
    row with no live key); the gate params once; the output written;
    2d FLOPs per product per live key."""
    q, k, key_len = args[0], args[1], args[-1]
    B, Tq, d = q.shape
    Tk = k.shape[1]
    es = q.element_size()
    live = key_len.clamp(0, Tk)
    n_live = int(live.sum().item())
    n_v = int(live.masked_fill(live == 0, Tk).sum().item())
    timed = mode != "plain"
    rows_q = (2 if mode == "time" else 1) * B * Tq * d * es
    keys = n_live * (d * es * (2 if mode == "time" else 1)
                     + (es if timed else 0))
    nbytes = (rows_q + (B * Tq * es if timed else 0) + keys + n_v * d * es
              + (5 * Tq * Tk * es if mode == "time" else 0) + B * 4
              + B * Tq * d * 4)
    flops = Tq * (n_live * 2 * d * (2 if mode == "time" else 1)
                  + n_v * 2 * d)
    return _bound(nbytes, flops, dtype_name)


def att_library(torch, mode, args):
    """The one PyTorch call that computes a mode, where there is one:
    scaled_dot_product_attention takes the plain mode's key mask, and the
    tisas mode's interval bias, as an additive mask (built here, outside
    the timed call).  The time mode multiplies the scores by a gate inside
    the softmax, which no library call takes, so it has none."""
    if mode == "time":
        return None
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, k, v, t_q, t_k, key_len = *args[:5], args[-1]
    d = q.shape[-1]
    col = torch.arange(k.shape[1], device=DEVICE)
    if mode == "tisas":
        bias = torch.log1p((t_q.float()[:, :, None]
                            - t_k.float()[:, None, :]).abs()) / math.sqrt(d)
    else:
        bias = torch.zeros(q.shape[0], q.shape[1], k.shape[1], device=DEVICE)
    bias = bias.masked_fill(col[None, None, :] >= key_len[:, None, None],
                            -(2.0 ** 32) + 1.0).to(q.dtype)
    return lambda: sdpa(q, k, v, attn_mask=bias)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _agree(got, want, dname, dead=None):
    """(max |diff|, max |diff| / max |want|, within the tolerance); outputs
    at `dead` positions must be exactly 0."""
    err, rel = rel_err(got, want)
    ok = bool(got.isfinite().all()) and rel <= KERNEL_TOL[dname]
    if dead is not None:
        ok = ok and not got[dead].any().item()
    return err, rel, ok


def check_kernels(torch, timer, iters, failures):
    """Each kernel mode against its plain twin at the request batches of
    the slice (B = 1, 16, 256); timed at B = 256."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in gk.MODES:
            err = rel = 0.0
            ok = True
            for bs in (1, 16, 256):
                args = gru_inputs(torch, gen, mode, dtype, B=bs)
                got = gk.gru_scan(mode, *args)
                want = gk.gru_scan_plain(mode, *args)
                dead = torch.arange(args[0].shape[1], device=DEVICE)[None, :] \
                    >= args[4][:, None]
                e, r, o = _agree(got, want, dname, dead)
                err, rel, ok = max(err, e), max(rel, r), ok and o
            row = {"max_abs_err": err, "rel_err": rel,
                   "tol": KERNEL_TOL[dname], "ok": ok,
                   "ms": timer(lambda: gk.gru_scan(mode, *args), iters),
                   "plain_ms": timer(lambda: gk.gru_scan_plain(mode, *args),
                                     max(iters // 10, 3)),
                   **gru_bound(mode, args, dname)}
            entries.setdefault(("gru_scan", mode), {})[dname] = row
            print(f"gru_scan {mode:8s} {dname:9s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"gru_scan {mode} {dname}: rel err {rel:.3e}")
        for mode in ak.MODES:
            for tk in (50, 1024):
                err = rel = 0.0
                ok = True
                for bs in (1, 16, 256):
                    args = att_inputs(torch, gen, dtype, B=bs, Tk=tk)
                    want = ak.fused_attention_plain(mode, *args)
                    e, r, o = _agree(ak.fused_attention(mode, *args), want,
                                     dname)
                    err, rel, ok = max(err, e), max(rel, r), ok and o
                row = {"max_abs_err": err, "rel_err": rel,
                       "tol": KERNEL_TOL[dname], "ok": ok,
                       "ms": timer(lambda: ak.fused_attention(mode, *args),
                                   iters),
                       "plain_ms": timer(
                           lambda: ak.fused_attention_plain(mode, *args),
                           max(iters // 10, 3)),
                       **att_bound(mode, args, dname)}
                library = att_library(torch, mode, args)
                if library is not None:
                    row["library_ms"] = timer(library, iters)
                    row["library_max_abs_err"] = rel_err(library(), want)[0]
                key = dname if tk == 50 else f"{dname}_tk1024"
                entries.setdefault(("fused_attention", mode), {})[key] = row
                print(f"fused_attention {mode:6s} Tk={tk:<5d}{dname:9s} "
                      f"max_abs_err={err:.3e} rel={rel:.3e} ms="
                      f"{row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"library_ms={row.get('library_ms')} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"fused_attention {mode} Tk={tk} {dname}:"
                                    f" rel err {rel:.3e}")
    return entries


# ------------------------------------------------------------ phase 3

def run_slice(torch, iters, failures):
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.models.mtam import init_mtam
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    from mtamrecommender_tpu_torch.serve import Recommender
    from mtamrecommender_tpu_torch.types import DatasetMeta

    meta = DatasetMeta(user_count=6040, item_count=3706, category_count=18,
                       max_seq_len=50)
    rows = []
    main_launches = {"gru_scan": {m: 0 for m in gk.MODES},
                     "fused_attention": {m: 0 for m in ak.MODES}}
    for dname in ("bfloat16", "float32"):
        cfg = ExperimentConfig().with_overrides(**{
            "model.experiment_type": "MTAM", "model.num_units": 128,
            "model.num_blocks": 3, "model.num_heads": 1,
            "model.dropout": 0.0, "model.use_pallas": True,
            "model.pallas_scope": "all", "model.compute_dtype": dname,
            "data.max_seq_len": 50})
        model = init_mtam(torch.Generator().manual_seed(0), cfg.model, meta)
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        for bs in (1, 16, 256):
            hists, req = make_histories(np.random.RandomState(bs), bs,
                                        meta.item_count, meta.category_count,
                                        meta.max_seq_len)
            if bs > 1:
                hists[1] = []                  # an empty history
            # --- the main path: counts from 0 around one recommend call
            for counts in (gk.launches, ak.launches):
                for m in counts:
                    counts[m] = 0
            recs = rec.recommend(hists, req, k=50)
            torch.cuda.synchronize()
            got = {"gru_scan": dict(gk.launches),
                   "fused_attention": dict(ak.launches)}
            for kname, counts in got.items():
                for m, n in counts.items():
                    main_launches[kname][m] += n
            want = {"gru_scan": {m: int(m == "tgru") for m in gk.MODES},
                    "fused_attention": {m: 3 * int(m == "time")
                                        for m in ak.MODES}}
            launches_ok = got == want
            shape_ok = len(recs) == bs and all(len(r) == 50 for r in recs) \
                and all(math.isfinite(s) for r in recs for _, s in r)
            # --- scores against the CPU plain path
            batch = rec.batch_from_histories(hists, req)
            batch_cpu = rec_cpu.batch_from_histories(hists, req)
            with torch.no_grad():
                s_gpu = scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                        batch, meta.item_vocab).cpu()
                s_cpu = scores_for_eval(rec_cpu.model_def, rec_cpu._model_c,
                                        cfg.model, batch_cpu,
                                        meta.item_vocab)
            finite = bool(torch.isfinite(s_gpu).all())
            err, rel = rel_err(s_gpu, s_cpu)
            tol_abs = SLICE_TOL[dname] * s_cpu.abs().max().item()
            top_gpu = torch.topk(s_gpu, 50, dim=1).indices
            kth_cpu = torch.topk(s_cpu, 50, dim=1).values[:, -1:]
            # an id only the card ranks in the top 50 must score within the
            # tolerance of the CPU's 50th score
            picked = torch.gather(s_cpu, 1, top_gpu)
            topk_ok = bool((picked >= kth_cpu - tol_abs).all())
            ok = (launches_ok and shape_ok and finite and topk_ok
                  and rel <= SLICE_TOL[dname])
            # --- time per request batch
            recommend_ms = _host_ms(torch, lambda: rec.recommend(
                hists, req, k=50), iters)
            fetch = min(50 + meta.max_seq_len, meta.item_vocab)
            score_ms = _event_ms(torch, lambda: rec._score_impl(batch, fetch),
                                 iters)
            busy = _device_busy(torch, lambda: rec._score_impl(batch, fetch))
            row = {"compute_dtype": dname, "batch": bs, "k": 50,
                   "launches_per_call": got, "launches_ok": launches_ok,
                   "max_abs_score_err": err, "rel_score_err": rel,
                   "tol": SLICE_TOL[dname], "topk_ok": topk_ok,
                   "recommend_ms": recommend_ms, "score_topk_ms": score_ms,
                   **busy, "idle_share": (None if busy["device_busy_ms"] is None
                                          else 1 - busy["device_busy_ms"]
                                          / score_ms),
                   "ok": ok}
            rows.append(row)
            print(f"slice {dname:9s} B={bs:<4d} launches={got} "
                  f"max_abs_score_err={err:.3e} rel={rel:.3e} "
                  f"topk_ok={topk_ok} recommend_ms={recommend_ms:.3f} "
                  f"score_topk_ms={score_ms:.3f} device_busy_ms="
                  f"{busy['device_busy_ms']} {'ok' if ok else 'FAIL'}",
                  flush=True)
            for name, ms in busy["top_kernels"]:
                print(f"    {ms:9.4f} ms  {name[:90]}", flush=True)
            if not ok:
                failures.append(f"slice {dname} B={bs}: {row}")
    return rows, main_launches


def _host_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _device_busy(torch, fn):
    """Device time of one call, summed over its kernels, from
    torch.profiler; None where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3)
               for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    kernels = sorted((k for k in kernels if k[1] > 0), key=lambda k: -k[1])
    total = sum(ms for _, ms in kernels)
    return {"device_busy_ms": total if total > 0 else None,
            "top_kernels": kernels[:8]}


def _event_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ report

def kernels_line(entries, main_launches):
    out = []
    for (kname, mode), by_dtype in entries.items():
        head = by_dtype["bfloat16"]        # the serving config computes in bf16
        out.append({
            "name": f"{kname}[{mode}]", "route": "cuda",
            "source": GRU_SOURCE if kname == "gru_scan" else ATT_SOURCE,
            "replaces": GRU_REPLACES if kname == "gru_scan" else ATT_REPLACES,
            "launches": main_launches[kname][mode],
            "max_abs_err": max(r["max_abs_err"] for r in by_dtype.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # None where no single PyTorch call computes the function: the
            # time gate sits between QK^T and the softmax, and the GRU
            # cell's reset gate multiplies h before its product (cuDNN's
            # after) and the time gate scales the candidate
            "library_ms": head.get("library_ms"),
            "by_dtype": {k: {kk: v for kk, v in r.items() if kk != "ok"}
                         for k, r in by_dtype.items()},
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 2
    from mtamrecommender_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # phase 1: card and build
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    for name, rep in built.items():
        ptxas = [ln.strip() for ln in rep["log"].splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"built {name} in {rep['seconds']:.1f} s", flush=True)
        for ln in ptxas:
            print(f"  {ln}", flush=True)
    print(f"build wall {build_s:.1f} s", flush=True)

    # phase 2: kernels against their plain twins
    timer = Timer(torch)
    entries = check_kernels(torch, timer, 100, failures)

    # phase 3: the slice
    slice_rows, main_launches = run_slice(torch, 20, failures)
    for kname, mode in (("gru_scan", "tgru"), ("fused_attention", "time")):
        if main_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "main path")

    report = kernels_line(entries, main_launches)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, **report,
                   "slice": slice_rows, "failures": failures}, f, indent=1)
    if failures:
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
