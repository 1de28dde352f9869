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
  2b. the training step's kernels the same way: gru_scan_bwd in each
     mode at B = 1, 16, 256, and dtable at the step's four table shapes
     with the ids of a gathered training batch (index_add_ timed beside
     it);
  2c. the self-attention training kernels the same way: the forward's
     plain_drop and tisas_drop modes (a rate-0.5 mask) and
     fused_attention_bwd in all five modes, at B = 1, 16, 256 with
     Tq = Tk = 50 and with Tq = 1, Tk = 1024, and the forward's plain,
     time and tisas modes at Tq = Tk = 50; two backward launches on the
     same inputs must give the same bits; timed at B = 256, Tq = Tk = 50
     (scaled_dot_product_attention forward + backward beside the plain
     and tisas backward);
  3. the serving slice: Recommender.recommend at full width (MTAM d=128,
     3 hops, L=50, the ml-1m catalog, k=50) for B = 1, 16, 256 in bf16
     and f32 compute, with launch counts per scoring call, scores held
     against the same Recommender on the CPU (the plain twins), and the
     time per request batch;
  4. the training slice: bench.py's MTAM step (B=256, L=50, d=128, 3
     hops, 4832 users, 3706 items, 18 categories, tables padded to 128
     rows, adam clipped to 1.0) on 4096 rows made from seed 0 and held
     on the card: one step's loss and every gradient leaf against the
     CPU in f32 and bf16, five f32 steps against the CPU, launch counts
     per step (1 gru_scan, 1 gru_scan_bwd, 4 dtable, 0 fused_attention),
     and the time per step, examples/s and device idle share in bf16
     and f32;
  5. the self-attention slice on the same data and catalog, 3 blocks,
     1 head: Time_Aware_Self_Attention_Model's step as phase 4 checks
     MTAM's (3 fused_attention[time] + 3 fused_attention_bwd[time] + 4
     dtable launches a step); SASrec's and TiSAS's step in f32 and bf16
     against the CPU with masks drawn on the CPU and injected on both
     sides (3 [*_drop] forward + 3 backward launches a step), then timed
     with the card's own generator drawing the masks; and
     Recommender.recommend for each of the three at B = 16 in bf16
     against the CPU.
The line before the last is {"kernels": [...]}, one entry per kernel, mode
and main-path shape (the attention kernels at Tq=1, Tk=50 as "@Tq1" and
at Tq=Tk=50 as "@Tq50"); the last line is
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

# kernel -> (its source, the TPU kernel body it replaces)
KERNEL_FILES = {
    "gru_scan": ("mtamrecommender_tpu_torch/csrc/gru_scan.cu",
                 "mtamrecommender_tpu/ops/pallas/gru_kernel.py:64"),
    "fused_attention": ("mtamrecommender_tpu_torch/csrc/fused_attention.cu",
                        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:60"),
    "gru_scan_bwd": ("mtamrecommender_tpu_torch/csrc/gru_scan_bwd.cu",
                     "mtamrecommender_tpu/ops/pallas/gru_kernel.py:174"),
    "dtable": ("mtamrecommender_tpu_torch/csrc/embedding_dtable.cu",
               "mtamrecommender_tpu/ops/pallas/embedding_kernel.py:174"),
    "fused_attention_bwd": (
        "mtamrecommender_tpu_torch/csrc/fused_attention_bwd.cu",
        "mtamrecommender_tpu/ops/pallas/attention_kernel.py:325"),
}
SERVING_MODES = ("plain", "time", "tisas")   # the forward modes phase 2 holds
SELF_ATTENTION = {"SASrec": "plain_drop",
                  "Time_Aware_Self_Attention_Model": "time",
                  "Ti_Self_Attention_Model": "tisas_drop"}
# the training step (bench.py's MTAM cell): card vs CPU, per gradient
# leaf, max |diff| / max |CPU f32 leaf|; in bf16 the CPU's own bf16-vs-f32
# gap is allowed on top (see PERF.md)
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAJ_LOSS_RTOL = 1e-4        # five f32 steps: each loss, relative
TRAJ_PARAM_ATOL = 2e-4       # five f32 steps: final parameters (lr 1e-3)
TRAIN_BATCH, TRAIN_ROWS = 256, 4096


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
    # self-attention (Tq = Tk) reads the keys' hours; a readout query sits
    # an hour after its last key
    t_q = t_k if Tq == Tk else (hours.max(dim=1, keepdim=True).values
                                + 1.0).expand(B, Tq).contiguous().to(dtype)
    key_len = torch.randint(1, Tk + 1, (B,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    key_len[:2] = torch.tensor([0, Tk], dtype=torch.int32)[:B]
    gate = [rand(Tq, Tk, scale=0.3) for _ in range(5)]
    return (rand(B, Tq, d).relu(), rand(B, Tk, d).relu(), rand(B, Tk, d).relu(),
            t_q, t_k, rand(B, Tq, d, scale=0.3), rand(B, Tk, d), *gate,
            key_len)


def weighted_pairs(args, dm=None):
    """(query, key) pairs the weighted sum reads: each live key (every
    key of a row with none live), and of those only the ones a dropout
    mask keeps.  Returns (all of them, those in rows with a live key)."""
    import torch

    k, key_len = args[1], args[-1]
    Tq, Tk = args[0].shape[1], k.shape[1]
    live = key_len.clamp(0, Tk)
    span = live.masked_fill(live == 0, Tk)
    col = torch.arange(Tk, device=k.device)
    reads = (col[None, None, :] < span[:, None, None]).expand(-1, Tq, -1)
    if dm is not None:
        reads = reads & (dm > 0)
    per_row = reads.sum(dim=(1, 2))
    return int(per_row.sum().item()), int(per_row[live > 0].sum().item())


def att_bound(mode, args, dtype_name, dm=None):
    """Least time: q (and tqw, t_q) read once; for each live key its k
    row (and rawk row, t_k) and its v row read once (all Tk v rows for a
    row with no live key); the gate params and the dropout mask once;
    the output written; 2d FLOPs per product per live (query, key) pair,
    the weighted sum's only for the pairs the mask keeps."""
    q, k, key_len = args[0], args[1], args[-1]
    B, Tq, d = q.shape
    Tk = k.shape[1]
    es = q.element_size()
    mode = mode.replace("_drop", "")
    live = key_len.clamp(0, Tk)
    n_live = int(live.sum().item())
    n_v = int(live.masked_fill(live == 0, Tk).sum().item())
    timed = mode != "plain"
    rows_q = (2 if mode == "time" else 1) * B * Tq * d * es
    keys = n_live * (d * es * (2 if mode == "time" else 1)
                     + (es if timed else 0))
    nbytes = (rows_q + (B * Tq * es if timed else 0) + keys + n_v * d * es
              + (5 * Tq * Tk * es if mode == "time" else 0) + B * 4
              + (B * Tq * Tk * 4 if dm is not None else 0)
              + B * Tq * d * 4)
    flops = (Tq * n_live * 2 * d * (2 if mode == "time" else 1)
             + weighted_pairs(args, dm)[0] * 2 * d)
    return _bound(nbytes, flops, dtype_name)


def att_library(torch, mode, args, g=None):
    """The one PyTorch call that computes a mode, where there is one:
    scaled_dot_product_attention takes the plain mode's key mask, and the
    tisas mode's interval bias, as an additive mask (built here, outside
    the timed call).  The time mode multiplies the scores by a gate inside
    the softmax, and the drop modes apply an injected mask after it,
    which no library call takes, so they have none.  With the cotangent
    ``g``: the forward and torch.autograd.grad of q, k and v ("fwd+bwd",
    since the backward kernel recomputes the forward too)."""
    if mode not in ("plain", "tisas"):
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
    if g is None:
        return lambda: sdpa(q, k, v, attn_mask=bias)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    cot = g.to(q.dtype)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves, attn_mask=bias), leaves, cot)
    return fwd_bwd


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
            entries.setdefault(("gru_scan", mode, None), {})[dname] = row
            print(f"gru_scan {mode:8s} {dname:9s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"gru_scan {mode} {dname}: rel err {rel:.3e}")
        for mode in SERVING_MODES:
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
                entries.setdefault(("fused_attention", mode, "Tq1"),
                                   {})[key] = row
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
            for counts in (gk.launches, ak.launches, ak.bwd_launches):
                for m in counts:
                    counts[m] = 0
            recs = rec.recommend(hists, req, k=50)
            torch.cuda.synchronize()
            got = {"gru_scan": dict(gk.launches),
                   "fused_attention": dict(ak.launches),
                   "fused_attention_bwd": dict(ak.bwd_launches)}
            for kname in main_launches:
                for m, n in got[kname].items():
                    main_launches[kname][m] += n
            want = {"gru_scan": {m: int(m == "tgru") for m in gk.MODES},
                    "fused_attention": {m: 3 * int(m == "time")
                                        for m in ak.MODES},
                    "fused_attention_bwd": {m: 0 for m in ak.MODES}}
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


# ------------------------------------------------------------ phase 2b

def gru_bwd_bound(mode, args, dtype_name):
    """Least time for the backward these inputs need: for each alive step
    g, h_prev and the step's inputs read once; h0 and the weights once;
    every cotangent written once; 18*u^2 FLOPs per alive step (the
    recomputed forward 6u^2, dh's two products 6u^2, the weight
    gradients 6u^2)."""
    gx, lengths = args[0], args[4]
    B, L, u2 = gx.shape
    u = u2 // 2
    es = gx.element_size()
    steps = int(lengths.clamp(0, L).sum().item())
    per_step = 8 * u + (2 * u + u + (0 if mode == "plain" else 2 * u)) * es
    nbytes = (steps * per_step + B * 4 + B * u * es + 3 * u * u * es
              + 7 * u * es + B * L * 5 * u * 4 + B * u * 4
              + (3 * u * u + 7 * u) * 4)
    return _bound(nbytes, steps * 18 * u * u, dtype_name)


def dtable_bound(ct, ids, vocab):
    """ct and ids read once, the table written once; one f32 add per
    element of ct, at the f32 rate."""
    n, d = ct.shape
    nbytes = n * d * ct.element_size() + 4 * n + vocab * d * ct.element_size()
    return _bound(nbytes, n * d, "float32")


def check_train_kernels(torch, timer, iters, failures, tables):
    """The training step's two new kernels against their plain twins:
    gru_scan_bwd in each mode at B = 1, 16, 256, and dtable at the step's
    four table shapes with ids from a gathered batch (``tables``: name ->
    (ids, vocab)); timed at B = 256."""
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in gk.MODES:
            err = rel = 0.0
            ok = True
            for bs in (1, 16, 256):
                args = gru_inputs(torch, gen, mode, dtype, B=bs)
                if bs == 1:
                    args[4].fill_(args[0].shape[1])   # one full-length row
                with torch.no_grad():
                    outs = gk.gru_scan(mode, *args)
                g = torch.randn(outs.shape, generator=gen, device=DEVICE)
                got = gk.gru_scan_bwd(mode, g, outs, *args)
                want = gk.gru_scan_bwd_plain(mode, g, outs, *args)
                for a, b in zip(got, want):
                    e, r, o = _agree(a, b, dname)
                    err, rel, ok = max(err, e), max(rel, r), ok and o
            row = {"max_abs_err": err, "rel_err": rel,
                   "tol": KERNEL_TOL[dname], "ok": ok,
                   "ms": timer(lambda: gk.gru_scan_bwd(mode, g, outs, *args),
                               iters),
                   "plain_ms": timer(
                       lambda: gk.gru_scan_bwd_plain(mode, g, outs, *args),
                       max(iters // 10, 3)),
                   **gru_bwd_bound(mode, args, dname)}
            entries.setdefault(("gru_scan_bwd", mode, None), {})[dname] = row
            print(f"gru_scan_bwd {mode:8s} {dname:9s} max_abs_err={err:.3e} "
                  f"rel={rel:.3e} ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"gru_scan_bwd {mode} {dname}: rel err "
                                f"{rel:.3e}")
        shapes = {}
        for table, (ids, vocab) in tables.items():
            ct = torch.randn((ids.shape[0], 128), generator=gen,
                             device=DEVICE).to(dtype)
            got = ek.dtable(ct, ids, vocab)
            want = ek.dtable_plain(ct, ids, vocab)
            err, rel, ok = _agree(got, want, dname)
            again = ek.dtable(ct, ids, vocab)
            ok = ok and bool(torch.equal(got, again))   # same bits each run
            ids64 = ids.long()
            shapes[table] = {
                "n": int(ids.shape[0]), "vocab": vocab,
                "max_abs_err": err, "rel_err": rel, "ok": ok,
                "ms": timer(lambda: ek.dtable(ct, ids, vocab), iters),
                "plain_ms": timer(lambda: ek.dtable_plain(ct, ids, vocab),
                                  iters),
                "library_ms": timer(lambda: torch.zeros(
                    (vocab, 128), dtype=dtype, device=DEVICE).index_add_(
                        0, ids64, ct), iters),
                **dtable_bound(ct, ids, vocab)}
            r = shapes[table]
            print(f"dtable {table:11s} n={r['n']:<6d} V={vocab:<5d} "
                  f"{dname:9s} max_abs_err={err:.3e} rel={rel:.3e} "
                  f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"index_add_ms={r['library_ms']:.4f} bound_ms="
                  f"{r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"dtable {table} {dname}: rel err {rel:.3e} "
                                "or not reproducible")
        head = shapes["item_table"]
        entries.setdefault(("dtable", None, None), {})[dname] = {
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "rel_err": max(r["rel_err"] for r in shapes.values()),
            "tol": KERNEL_TOL[dname],
            "ok": all(r["ok"] for r in shapes.values()), "by_table": shapes}
    return entries


# ------------------------------------------------------------ phase 2c

def att_bwd_bound(mode, args, dm, dtype_name):
    """Least time for the backward these inputs need: g, q (and tqw, t_q)
    read once; for each live key its k and v rows (and rawk row, t_k);
    the gate params, key_len and the mask once; the f32 outputs written
    once: dq, dk and dv, and in time mode dtqw, drawk and the five gate
    gradients (the output depends on those inputs in time mode only).
    2d FLOPs per product per live (query, key) pair:
    the recomputed QK^T (and tqw.rawk in time mode), dq and dk (and dtqw,
    drawk in time mode); dv and g V^T only for the pairs the weighted
    sum reads (`weighted_pairs`: a row with no live key needs only dv,
    and a dropped pair neither)."""
    q, k, key_len = args[0], args[1], args[-1]
    B, Tq, d = q.shape
    Tk = k.shape[1]
    es = q.element_size()
    base = mode.replace("_drop", "")
    n_live = int(key_len.clamp(0, Tk).sum().item())
    timed = base != "plain"
    time_mode = base == "time"
    nbytes = (B * Tq * d * 4                                  # g
              + B * Tq * d * es * (2 if time_mode else 1)     # q, tqw
              + (B * Tq * es if timed else 0)                 # t_q
              + n_live * (d * es * (3 if time_mode else 2)
                          + (es if timed else 0))             # k, v, rawk, t_k
              + (5 * Tq * Tk * es if time_mode else 0) + B * 4
              + (B * Tq * Tk * 4 if dm is not None else 0)
              + B * Tq * d * 4 * (2 if time_mode else 1)       # dq, dtqw
              + B * Tk * d * 4 * (3 if time_mode else 2)       # dk, dv, drawk
              + (5 * Tq * Tk * 4 if time_mode else 0))         # gate grads
    products = (2 if time_mode else 1) + 2 + (2 if time_mode else 0)
    # dv over every read pair; g V^T over the read pairs of live rows
    reads, live_reads = weighted_pairs(args, dm)
    flops = 2 * d * (Tq * n_live * products + reads + live_reads)
    return _bound(nbytes, flops, dtype_name)


def check_attention_training(torch, timer, iters, failures):
    """The self-attention training kernels against their plain twins:
    the forward's drop modes and its other modes at Tq = Tk = 50, the
    backward in every mode, at B = 1, 16, 256 and at Tq = 1, Tk = 1024;
    two backward launches must give the same bits; timed at B = 256."""
    from mtamrecommender_tpu_torch.ops import layers
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device=DEVICE).manual_seed(2468)
    entries = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in ak.MODES:
            drop = mode.endswith("_drop")
            for tq, tk in ((50, 50), (1, 1024)):
                check_fwd = drop or tq > 1     # phase 2 holds Tq = 1
                fwd = {"err": 0.0, "rel": 0.0, "ok": True}
                bwd = {"err": 0.0, "rel": 0.0, "ok": True}
                same = True
                for bs in (1, 16, 256):
                    args = att_inputs(torch, gen, dtype, B=bs, Tq=tq, Tk=tk)
                    dm = (layers.draw_drop_mask(gen, bs, tq, tk, 0.5, DEVICE)
                          if drop else None)
                    if check_fwd:
                        want = ak.fused_attention_plain(mode, *args, dm)
                        e, r, o = _agree(ak.fused_attention(mode, *args, dm),
                                         want, dname)
                        fwd = {"err": max(fwd["err"], e),
                               "rel": max(fwd["rel"], r),
                               "ok": fwd["ok"] and o}
                    g = torch.randn(args[0].shape, generator=gen,
                                    device=DEVICE)
                    got = ak.fused_attention_bwd(mode, g, *args, dm)
                    again = ak.fused_attention_bwd(mode, g, *args, dm)
                    want = ak.fused_attention_bwd_plain(mode, g, *args, dm)
                    # outside time mode dtqw, drawk and the gate
                    # gradients are None, on the card and in the twin
                    outputs = 10 if mode == "time" else 3
                    shaped = all([t is not None for t in outs]
                                 == [i < outputs for i in range(10)]
                                 for outs in (got, again, want))
                    same = same and shaped and all(
                        torch.equal(a, b)
                        for a, b in zip(got[:outputs], again[:outputs]))
                    bwd["ok"] = bwd["ok"] and shaped
                    for a, b in zip(got[:outputs], want[:outputs]):
                        e, r, o = _agree(a, b, dname)
                        bwd = {"err": max(bwd["err"], e),
                               "rel": max(bwd["rel"], r),
                               "ok": bwd["ok"] and o}
                key = dname if tq > 1 else f"{dname}_tq1_tk1024"
                tag = f"Tq={tq} Tk={tk}"
                if check_fwd:
                    row = {"max_abs_err": fwd["err"], "rel_err": fwd["rel"],
                           "tol": KERNEL_TOL[dname], "ok": fwd["ok"],
                           "ms": timer(lambda: ak.fused_attention(
                               mode, *args, dm), iters),
                           "plain_ms": timer(lambda: ak.fused_attention_plain(
                               mode, *args, dm), max(iters // 10, 3)),
                           **att_bound(mode, args, dname, dm)}
                    library = att_library(torch, mode, args)
                    if library is not None:
                        row["library_ms"] = timer(library, iters)
                    entries.setdefault(("fused_attention", mode, "Tq50"),
                                       {})[key] = row
                    print(f"fused_attention {mode:10s} {tag:15s} {dname:9s} "
                          f"max_abs_err={fwd['err']:.3e} rel={fwd['rel']:.3e} "
                          f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                          f"bound_ms={row['bound_ms']:.4f} "
                          f"library_ms={row.get('library_ms')} "
                          f"{'ok' if fwd['ok'] else 'FAIL'}", flush=True)
                    if not fwd["ok"]:
                        failures.append(f"fused_attention {mode} {tag} "
                                        f"{dname}: rel err {fwd['rel']:.3e}")
                row = {"max_abs_err": bwd["err"], "rel_err": bwd["rel"],
                       "tol": KERNEL_TOL[dname], "ok": bwd["ok"] and same,
                       "same_bits_twice": same,
                       "ms": timer(lambda: ak.fused_attention_bwd(
                           mode, g, *args, dm), iters),
                       "plain_ms": timer(lambda: ak.fused_attention_bwd_plain(
                           mode, g, *args, dm), max(iters // 10, 3)),
                       **att_bwd_bound(mode, args, dm, dname)}
                library = att_library(torch, mode, args, g)
                if library is not None:
                    row["library_ms"] = timer(library, iters)
                    row["library_call"] = ("scaled_dot_product_attention "
                                           "fwd+bwd")
                entries.setdefault(("fused_attention_bwd", mode, "Tq50"),
                                   {})[key] = row
                print(f"fused_attention_bwd {mode:10s} {tag:15s} {dname:9s} "
                      f"max_abs_err={bwd['err']:.3e} rel={bwd['rel']:.3e} "
                      f"same_bits={same} ms={row['ms']:.4f} plain_ms="
                      f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                      f"({row['bound_by']}) library_ms="
                      f"{row.get('library_ms')} "
                      f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
                if not row["ok"]:
                    failures.append(f"fused_attention_bwd {mode} {tag} "
                                    f"{dname}: rel err {bwd['rel']:.3e}, "
                                    f"same bits {same}")
    return entries


# ------------------------------------------------------------ phase 4

def make_train_arrays(meta, n, seed=0):
    """n packed training rows: a numpy copy of __graft_entry__._make_batch
    (same draws, same order) without the JAX arrays."""
    rng = np.random.RandomState(seed)
    L = meta.max_seq_len
    seq_len = rng.randint(2, L + 1, n).astype(np.int32)
    items = np.zeros((n, L), np.int32)
    cats = np.zeros((n, L), np.int32)
    times = np.zeros((n, L), np.float32)
    for b in range(n):
        k = int(seq_len[b])
        items[b, :k] = rng.randint(1, meta.item_count + 1, k)
        items[b, k - 1] = meta.item_count + 1
        cats[b, :k] = rng.randint(1, meta.category_count + 1, k)
        cats[b, k - 1] = meta.category_count + 1
        times[b, :k] = np.sort(rng.rand(k).astype(np.float32) * 1000)
    tl = np.zeros((n, L), np.float32)
    tn = np.zeros((n, L), np.float32)
    pos = np.zeros((n, L), np.int32)
    for b in range(n):
        k = int(seq_len[b])
        tl[b, 1:k] = times[b, 1:k] - times[b, :k - 1]
        tn[b, :k] = times[b, k - 1] - times[b, :k]
        pos[b, :k] = np.arange(k)
    return dict(
        user_id=rng.randint(1, meta.user_count + 1, n).astype(np.int32),
        items=items, cats=cats, times=times, time_last=tl, time_now=tn,
        positions=pos,
        target_id=rng.randint(1, meta.item_count + 1, n).astype(np.int32),
        target_cat=rng.randint(1, meta.category_count + 1, n).astype(np.int32),
        target_time=(times.max(1) + 1).astype(np.float32), seq_len=seq_len)


def train_cfg(dname, name="MTAM"):
    """The training cell's configuration for model ``name``: d=128, 3
    hops or blocks, 1 head, the default dropout (0.5: SASrec and TiSAS
    drop attention weights, MTAM and the time-aware SA model draw
    nothing)."""
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides(**{
        "model.experiment_type": name, "model.num_units": 128,
        "model.num_blocks": 3, "model.vocab_pad_multiple": 128,
        "model.compute_dtype": dname, "model.use_pallas": True,
        "model.pallas_scope": "gru" if name == "MTAM" else "all",
        "data.max_seq_len": 50, "train.train_batch_size": TRAIN_BATCH})


class TrainSetup:
    """The training cell: bench.py's MTAM configuration, 4096 rows from
    make_train_arrays on the card and on the CPU, one epoch order."""

    def __init__(self, torch):
        from mtamrecommender_tpu_torch.data.device_data import (epoch_order,
                                                                 gather_batch,
                                                                 to_device)
        from mtamrecommender_tpu_torch.ops.embedding import pad_vocab
        from mtamrecommender_tpu_torch.types import DatasetMeta

        self.meta = DatasetMeta(user_count=4832, item_count=3706,
                                category_count=18, max_seq_len=50)
        arrays = make_train_arrays(self.meta, TRAIN_ROWS, seed=0)
        self.data = to_device(arrays)               # CUDA: the default
        self.data_cpu = to_device(arrays, device="cpu")
        epochs = [epoch_order(TRAIN_ROWS, TRAIN_BATCH,
                              np.random.RandomState(e))[0] for e in range(3)]
        self.order_np = np.concatenate(epochs)
        self.order = torch.tensor(self.order_np, device=DEVICE)
        self.order_cpu = torch.tensor(self.order_np)
        self.batch = gather_batch(self.data, self.order, 0, TRAIN_BATCH)
        self.batch_cpu = gather_batch(self.data_cpu, self.order_cpu, 0,
                                      TRAIN_BATCH)
        # the step's four lookups: table -> (the first batch's flat int32
        # ids, padded vocab); every id of the dataset is checked on the
        # card to lie in [0, vocab), which the dtable kernel does not do
        m = self.meta
        self.tables, self.ids_in_range = {}, {}
        for table, field, vocab in (
                ("user_table", "user_id", m.user_vocab),
                ("item_table", "items", m.item_vocab),
                ("cat_table", "cats", m.category_vocab),
                ("pos_table", "positions", m.position_vocab)):
            v = pad_vocab(vocab, 128)
            ids = getattr(self.batch, field).reshape(-1).contiguous()
            self.tables[table] = (ids, v)
            col = getattr(self.data, field)
            self.ids_in_range[table] = bool(((col >= 0) & (col < v)).all())

    def model(self, torch, cfg, device):
        from mtamrecommender_tpu_torch.models.registry import get_model
        return get_model(cfg.model.experiment_type).init(
            torch.Generator().manual_seed(0), cfg.model,
            self.meta).to(device)


def _loss_grads(torch, cfg, model, batch, vocab, drop_masks=None):
    """One step's loss and gradients; ``drop_masks``, where given, are
    the forward's masks in block order (its mask source)."""
    from mtamrecommender_tpu_torch.models.base import compute_loss
    from mtamrecommender_tpu_torch.models.registry import get_model

    model.zero_grad(set_to_none=True)
    source = None if drop_masks is None else iter(drop_masks)
    metrics = compute_loss(get_model(cfg.model.experiment_type), model,
                           cfg.model, batch, vocab, gen=source)
    metrics["loss"].backward()
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()})


def _counts(gk, ak, ek):
    return {"gru_scan": dict(gk.launches), "gru_scan_bwd": dict(gk.bwd_launches),
            "fused_attention": dict(ak.launches),
            "fused_attention_bwd": dict(ak.bwd_launches),
            "dtable": dict(ek.launches)}


def _reset_counts(gk, ak, ek):
    for counts in (gk.launches, gk.bwd_launches, ak.launches,
                   ak.bwd_launches, ek.launches):
        for m in counts:
            counts[m] = 0


def _want_counts(steps, gru=None, attention=None, blocks=3):
    """Launches after ``steps`` training steps: 4 dtable a step; the GRU
    scan and its backward once a step in mode ``gru``; the attention
    forward and backward ``blocks`` times a step in mode ``attention``."""
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk

    gru_counts = {m: steps * int(m == gru) for m in gk.MODES}
    att = {m: steps * blocks * int(m == attention) for m in ak.MODES}
    return {"gru_scan": gru_counts, "gru_scan_bwd": dict(gru_counts),
            "fused_attention": att, "fused_attention_bwd": dict(att),
            "dtable": {"dtable": 4 * steps}}


def _kernel_modules():
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    return gk, ak, ek


def one_step_check(torch, setup, failures, name, want, drop_masks=None):
    """One step's loss and every gradient leaf on the card against the
    CPU (the plain twins), in f32 and bf16, and the step's launches
    against ``want``.  ``drop_masks``: CPU masks, one per block, injected
    on both sides."""
    gk, ak, ek = _kernel_modules()
    vocab = setup.meta.item_vocab
    on_card = None if drop_masks is None else [m.to(DEVICE)
                                                for m in drop_masks]
    report, cpu32 = {}, None
    for dname in ("float32", "bfloat16"):
        cfg = train_cfg(dname, name)
        m_cpu, g_cpu = _loss_grads(torch, cfg, setup.model(torch, cfg, "cpu"),
                                   setup.batch_cpu, vocab, drop_masks)
        if dname == "float32":
            cpu32 = g_cpu
        _reset_counts(gk, ak, ek)
        m_gpu, g_gpu = _loss_grads(torch, cfg, setup.model(torch, cfg, DEVICE),
                                   setup.batch, vocab, on_card)
        torch.cuda.synchronize()
        counts = _counts(gk, ak, ek)
        worst, worst_leaf, ok = 0.0, None, True
        by_leaf = {}
        for leaf, g in g_gpu.items():
            scale = max(cpu32[leaf].abs().max().item(), 1e-30)
            diff = (g - g_cpu[leaf]).abs().max().item()
            by_leaf[leaf] = diff / scale
            allowed = TRAIN_TOL[dname] * scale
            if dname == "bfloat16":
                allowed += (g_cpu[leaf] - cpu32[leaf]).abs().max().item()
            finite = bool(torch.isfinite(g).all())
            ok = ok and finite and diff <= allowed
            if diff / scale > worst:
                worst, worst_leaf = diff / scale, leaf
        loss_rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                    for k in m_cpu}
        ok = ok and max(loss_rel.values()) <= TRAIN_TOL[dname] \
            and counts == want(1)
        report[f"one_step_{dname}"] = {
            "loss_gpu": m_gpu, "loss_cpu": m_cpu, "loss_rel_err": loss_rel,
            "worst_grad_rel_err": worst, "worst_leaf": worst_leaf,
            "grad_rel_err_by_leaf": by_leaf, "launches": counts, "ok": ok}
        print(f"train {name} one step {dname:9s} loss gpu="
              f"{m_gpu['loss']:.6f} cpu={m_cpu['loss']:.6f} worst grad rel "
              f"err={worst:.3e} ({worst_leaf}) launches={counts} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"training {name} one step {dname}: "
                            f"{report[f'one_step_{dname}']}")
    return report


def five_steps_check(torch, setup, failures, name):
    """Five f32 make_superstep steps on the card against the CPU: each
    loss and the final parameters."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                         make_superstep)

    cfg = train_cfg("float32", name)
    traj = {}
    for device, data, order in (("cpu", setup.data_cpu, setup.order_cpu),
                                (DEVICE, setup.data, setup.order)):
        model = setup.model(torch, cfg, device)
        opt = make_optimizer(cfg.train)
        run = make_superstep(get_model(name), cfg, opt, setup.meta.item_vocab,
                             TRAIN_BATCH, device=device)
        _, stacked = run(model, opt.init(model), data, order, 0, 5)
        traj[device] = (stacked["loss"].cpu(),
                        {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
    loss_err = ((traj[DEVICE][0] - traj["cpu"][0]).abs()
                / traj["cpu"][0].abs()).max().item()
    param_err = max((traj[DEVICE][1][n] - p).abs().max().item()
                    for n, p in traj["cpu"][1].items())
    ok = loss_err <= TRAJ_LOSS_RTOL and param_err <= TRAJ_PARAM_ATOL \
        and bool(torch.isfinite(traj[DEVICE][0]).all())
    report = {"losses_gpu": traj[DEVICE][0].tolist(),
              "losses_cpu": traj["cpu"][0].tolist(),
              "loss_rel_err": loss_err, "param_max_abs_err": param_err,
              "ok": ok}
    print(f"train {name} five f32 steps losses={traj[DEVICE][0].tolist()} "
          f"loss rel err={loss_err:.3e} param max abs err={param_err:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"training {name} trajectory: {report}")
    return report


def timed_steps(torch, setup, failures, name, want, main_launches):
    """The main path: 20 make_superstep steps per dtype after 3 warm-up
    steps, the launch counts from 0 around them (added to
    ``main_launches``), CUDA events around them, then the profiler's
    device time over 3 more steps.  Masks, where the model drops, come
    from the step's own generator on the card."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                         make_superstep)
    gk, ak, ek = _kernel_modules()
    report = {}
    steps, warm = 20, 3      # per dtype; the order holds 48 steps
    for dname in ("bfloat16", "float32"):
        cfg = train_cfg(dname, name)
        model = setup.model(torch, cfg, DEVICE)
        opt = make_optimizer(cfg.train)
        run = make_superstep(get_model(name), cfg, opt, setup.meta.item_vocab,
                             TRAIN_BATCH)
        state, _ = run(model, opt.init(model), setup.data, setup.order, 0,
                       warm)
        torch.cuda.synchronize()
        _reset_counts(gk, ak, ek)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, stacked = run(model, state, setup.data, setup.order, warm,
                             steps)
        end.record()
        end.synchronize()
        counts = _counts(gk, ak, ek)
        ms = start.elapsed_time(end) / steps
        _add_launches(main_launches, counts)
        busy = _device_busy(torch, lambda: run(
            model, state, setup.data, setup.order, warm + steps, 3))
        busy_ms = (None if busy["device_busy_ms"] is None
                   else busy["device_busy_ms"] / 3)
        losses = stacked["loss"].cpu()
        ok = counts == want(steps) and bool(torch.isfinite(losses).all())
        report[f"timed_{dname}"] = {
            "steps": steps, "ms_per_step": ms,
            "examples_per_s": TRAIN_BATCH / ms * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / ms,
            "top_kernels": busy["top_kernels"][:5], "launches": counts,
            "losses": losses.tolist(), "ok": ok}
        r = report[f"timed_{dname}"]
        print(f"train {name} {dname:9s} B={TRAIN_BATCH} ms/step={ms:.3f} "
              f"examples/s={r['examples_per_s']:.1f} device busy ms/step="
              f"{busy_ms} idle_share={r['idle_share']} launches/{steps} "
              f"steps={counts} {'ok' if ok else 'FAIL'}", flush=True)
        for kname, kms in busy["top_kernels"][:5]:
            print(f"    {kms / 3:9.4f} ms/step  {kname[:90]}", flush=True)
        if not ok:
            failures.append(f"training {name} timed {dname}: launches "
                            f"{counts}")
    return report


def _add_launches(main_launches, counts):
    for kname, by_mode in counts.items():
        for mode, n in by_mode.items():
            mode = None if kname == "dtable" else mode
            per = main_launches.setdefault(kname, {})
            per[mode] = per.get(mode, 0) + n


def run_training(torch, setup, failures):
    """Phase 4: MTAM's step, one step and five f32 steps against the CPU,
    then timed in bf16 and f32."""
    report = {"ids_in_range": setup.ids_in_range}
    if not all(report["ids_in_range"].values()):
        failures.append(f"training ids out of range: {report['ids_in_range']}")
    want = lambda steps: _want_counts(steps, gru="tgru")  # noqa: E731
    report.update(one_step_check(torch, setup, failures, "MTAM", want))
    report["five_steps_float32"] = five_steps_check(torch, setup, failures,
                                                    "MTAM")
    main_launches = {}
    report.update(timed_steps(torch, setup, failures, "MTAM", want,
                              main_launches))
    return report, main_launches


# ------------------------------------------------------------ phase 5

def run_self_attention(torch, setup, failures):
    """Phase 5: the three self-attention models on phase 4's data.
    Time_Aware_SA as phase 4 checks MTAM; SASrec and TiSAS one step in
    f32 and bf16 with masks drawn on the CPU and injected on both sides,
    then timed with the card's generator; Recommender.recommend for each
    at B = 16 in bf16 against the CPU."""
    from mtamrecommender_tpu_torch.ops import layers

    report, main_launches = {}, {}
    L = setup.meta.max_seq_len
    for name, mode in SELF_ATTENTION.items():
        want = lambda steps, m=mode: _want_counts(steps, attention=m)  # noqa: E731
        masks = None
        if mode.endswith("_drop"):
            cpu_gen = torch.Generator().manual_seed(99)
            masks = [layers.draw_drop_mask(cpu_gen, TRAIN_BATCH, L, L, 0.5,
                                           "cpu") for _ in range(3)]
        rep = one_step_check(torch, setup, failures, name, want, masks)
        if masks is None:
            rep["five_steps_float32"] = five_steps_check(torch, setup,
                                                         failures, name)
        rep.update(timed_steps(torch, setup, failures, name, want,
                               main_launches))
        report[name] = rep
    serving, serve_launches = serve_self_attention(torch, setup, failures)
    report["serving"] = serving
    _add_launches(main_launches, serve_launches)
    return report, main_launches


def serve_self_attention(torch, setup, failures):
    """Recommender.recommend for each self-attention model at B = 16 in
    bf16 (the serving config), launch counts around the call (3 forward
    launches of the model's mode, no backward), then its scores against
    the same Recommender on the CPU."""
    from mtamrecommender_tpu_torch.models.base import scores_for_eval
    from mtamrecommender_tpu_torch.serve import Recommender
    gk, ak, ek = _kernel_modules()

    meta, rows = setup.meta, {}
    total = {}
    hists, req = make_histories(np.random.RandomState(16), 16,
                                meta.item_count, meta.category_count,
                                meta.max_seq_len)
    hists[1] = []                                 # an empty history
    for name, mode in SELF_ATTENTION.items():
        cfg = train_cfg("bfloat16", name)
        model = setup.model(torch, cfg, "cpu")
        rec_cpu = Recommender(cfg, meta, copy.deepcopy(model), device="cpu")
        rec = Recommender(cfg, meta, model, device=DEVICE)
        _reset_counts(gk, ak, ek)
        recs = rec.recommend(hists, req, k=50)
        torch.cuda.synchronize()
        counts = _counts(gk, ak, ek)
        _add_launches(total, counts)
        base = mode.replace("_drop", "")
        want = _want_counts(0)
        want["fused_attention"][base] = 3
        batch = rec.batch_from_histories(hists, req)
        with torch.no_grad():
            s_gpu = scores_for_eval(rec.model_def, rec._model_c, cfg.model,
                                    batch, meta.item_vocab).cpu()
            s_cpu = scores_for_eval(rec_cpu.model_def, rec_cpu._model_c,
                                    cfg.model,
                                    rec_cpu.batch_from_histories(hists, req),
                                    meta.item_vocab)
        # the catalog's columns only: the table is padded to 128 rows, and
        # the padded columns' -2^32+1 would swamp the largest |score|
        vocab = meta.item_vocab
        err, rel = rel_err(s_gpu[:, :vocab], s_cpu[:, :vocab])
        ok = (counts == want and rel <= SLICE_TOL["bfloat16"]
              and bool(torch.isfinite(s_gpu).all())
              and all(len(r) == 50 for r in recs))
        rows[name] = {"launches": counts, "max_abs_score_err": err,
                      "rel_score_err": rel, "tol": SLICE_TOL["bfloat16"],
                      "ok": ok}
        print(f"serve {name} bf16 B=16 launches={counts['fused_attention']} "
              f"max_abs_score_err={err:.3e} rel={rel:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"serving {name}: {rows[name]}")
    return rows, total


# ------------------------------------------------------------ report

def kernels_line(entries, launches_by_shape):
    """One entry per kernel, mode and main-path shape: the attention
    kernels at Tq=1, Tk=50 (MTAM's readout hops, ``@Tq1``) and at
    Tq=Tk=50 (the self-attention blocks, ``@Tq50``), each with the ms,
    bound and launches of that shape (``launches_by_shape[shape]``; the
    kernels without a shape count every path's launches under None)."""
    out = []
    for (kname, mode, shape), by_dtype in entries.items():
        # serving and training both compute in bf16; dtable's head row is
        # the item table, the largest of its four shapes; the other
        # shapes each entry was checked at (Tk=1024) are in by_dtype
        head = by_dtype["bfloat16"]
        name = f"{kname}[{mode}]" if mode else kname
        out.append({
            "name": f"{name}@{shape}" if shape else name, "route": "cuda",
            "source": KERNEL_FILES[kname][0],
            "replaces": KERNEL_FILES[kname][1],
            "launches": launches_by_shape[shape].get(kname, {}).get(mode, 0),
            "max_abs_err": max(r["max_abs_err"] for r in by_dtype.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # None where no single PyTorch call computes the function: the
            # time gate sits between QK^T and the softmax, and the GRU
            # cell's reset gate multiplies h before its product (cuDNN's
            # after) and the time gate scales the candidate (forward and
            # backward alike); dtable's is index_add_; the plain and tisas
            # backward's is scaled_dot_product_attention fwd+bwd
            "library_ms": head.get("library_ms"),
            "library_call": head.get("library_call"),
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

    # phase 2b: the training step's kernels, at its shapes and ids
    setup = TrainSetup(torch)
    entries.update(check_train_kernels(torch, timer, 100, failures,
                                       setup.tables))

    # phase 2c: the self-attention training kernels
    for key, by_dtype in check_attention_training(torch, timer, 100,
                                                  failures).items():
        entries.setdefault(key, {}).update(by_dtype)

    # phase 3: the serving slice
    slice_rows, serve_launches = run_slice(torch, 20, failures)
    for kname, mode in (("gru_scan", "tgru"), ("fused_attention", "time")):
        if serve_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "serving path")

    # phase 4: the training slice
    training, train_launches = run_training(torch, setup, failures)
    for kname, mode in (("gru_scan", "tgru"), ("gru_scan_bwd", "tgru"),
                        ("dtable", None)):
        if train_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "training path")

    # phase 5: the self-attention slice
    self_attention, sa_launches = run_self_attention(torch, setup, failures)
    for kname, mode in (("fused_attention", "time"),
                        ("fused_attention_bwd", "time"),
                        ("fused_attention", "plain_drop"),
                        ("fused_attention_bwd", "plain_drop"),
                        ("fused_attention", "tisas_drop"),
                        ("fused_attention_bwd", "tisas_drop"),
                        ("fused_attention", "plain"),
                        ("fused_attention", "tisas"), ("dtable", None)):
        if sa_launches[kname][mode] == 0:
            failures.append(f"{kname}[{mode}] was never launched on the "
                            "self-attention paths")

    # launches on the main paths: MTAM's (phases 3 and 4) run the
    # attention kernels at Tq=1, the self-attention models' (phase 5) at
    # Tq=Tk=50
    mtam_launches = {k: dict(v) for k, v in serve_launches.items()}
    _add_launches(mtam_launches, train_launches)
    main_launches = copy.deepcopy(mtam_launches)
    _add_launches(main_launches, sa_launches)
    report = kernels_line(entries, {None: main_launches,
                                    "Tq1": mtam_launches,
                                    "Tq50": sa_launches})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, **report,
                   "slice": slice_rows, "training": training,
                   "launches_serving": serve_launches,
                   "launches_training": {k: {str(m): n for m, n in v.items()}
                                         for k, v in train_launches.items()},
                   "self_attention": self_attention,
                   "launches_self_attention": {
                       k: {str(m): n for m, n in v.items()}
                       for k, v in sa_launches.items()},
                   "failures": failures}, f, indent=1, default=str)
    if failures:
        for msg in failures:
            print(f"FAIL {msg}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    # the printed line leaves each dtype's detail to the JSON report
    print(json.dumps({"kernels": [
        {k: v for k, v in entry.items() if k != "by_dtype"}
        for entry in report["kernels"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
