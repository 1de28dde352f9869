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
     and f32.
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
}
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
            entries.setdefault(("gru_scan_bwd", mode), {})[dname] = row
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
        entries.setdefault(("dtable", None), {})[dname] = {
            **{k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "rel_err": max(r["rel_err"] for r in shapes.values()),
            "tol": KERNEL_TOL[dname],
            "ok": all(r["ok"] for r in shapes.values()), "by_table": shapes}
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


def train_cfg(dname):
    from mtamrecommender_tpu_torch.config import ExperimentConfig
    return ExperimentConfig().with_overrides(**{
        "model.experiment_type": "MTAM", "model.num_units": 128,
        "model.num_blocks": 3, "model.vocab_pad_multiple": 128,
        "model.compute_dtype": dname, "model.use_pallas": True,
        "model.pallas_scope": "gru", "data.max_seq_len": 50,
        "train.train_batch_size": TRAIN_BATCH})


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
        from mtamrecommender_tpu_torch.models.mtam import init_mtam
        return init_mtam(torch.Generator().manual_seed(0), cfg.model,
                         self.meta).to(device)


def _loss_grads(torch, cfg, model, batch, vocab):
    from mtamrecommender_tpu_torch.models.base import compute_loss
    from mtamrecommender_tpu_torch.models.registry import get_model

    model.zero_grad(set_to_none=True)
    metrics = compute_loss(get_model("MTAM"), model, cfg.model, batch, vocab)
    metrics["loss"].backward()
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()})


def _counts(gk, ak, ek):
    return {"gru_scan": dict(gk.launches), "gru_scan_bwd": dict(gk.bwd_launches),
            "fused_attention": dict(ak.launches), "dtable": dict(ek.launches)}


def _reset_counts(gk, ak, ek):
    for counts in (gk.launches, gk.bwd_launches, ak.launches, ek.launches):
        for m in counts:
            counts[m] = 0


def _step_counts_ok(counts, steps):
    want = {"gru_scan": {"plain": 0, "tseqrec": 0, "tgru": steps},
            "gru_scan_bwd": {"plain": 0, "tseqrec": 0, "tgru": steps},
            "fused_attention": {"plain": 0, "time": 0, "tisas": 0},
            "dtable": {"dtable": 4 * steps}}
    return counts == want


def run_training(torch, setup, failures):
    """Phase 4: gradients of one step and a five-step f32 trajectory on
    the card against the same on the CPU (the plain twins), launch counts
    per step, then the time per step in bf16 and f32."""
    from mtamrecommender_tpu_torch.models.registry import get_model
    from mtamrecommender_tpu_torch.ops.kernels import attention_kernel as ak
    from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as ek
    from mtamrecommender_tpu_torch.ops.kernels import gru_kernel as gk
    from mtamrecommender_tpu_torch.train.trainer import (make_optimizer,
                                                         make_superstep)

    vocab = setup.meta.item_vocab
    report = {"ids_in_range": setup.ids_in_range}
    if not all(report["ids_in_range"].values()):
        failures.append(f"training ids out of range: {report['ids_in_range']}")

    # --- one step's loss and gradients, card against CPU
    cpu32 = None
    for dname in ("float32", "bfloat16"):
        cfg = train_cfg(dname)
        m_cpu, g_cpu = _loss_grads(torch, cfg, setup.model(torch, cfg, "cpu"),
                                   setup.batch_cpu, vocab)
        if dname == "float32":
            cpu32 = g_cpu
        _reset_counts(gk, ak, ek)
        m_gpu, g_gpu = _loss_grads(torch, cfg, setup.model(torch, cfg, DEVICE),
                                   setup.batch, vocab)
        torch.cuda.synchronize()
        counts = _counts(gk, ak, ek)
        worst, worst_leaf, ok = 0.0, None, True
        by_leaf = {}
        for name, g in g_gpu.items():
            scale = max(cpu32[name].abs().max().item(), 1e-30)
            diff = (g - g_cpu[name]).abs().max().item()
            by_leaf[name] = diff / scale
            allowed = TRAIN_TOL[dname] * scale
            if dname == "bfloat16":
                allowed += (g_cpu[name] - cpu32[name]).abs().max().item()
            finite = bool(torch.isfinite(g).all())
            ok = ok and finite and diff <= allowed
            if diff / scale > worst:
                worst, worst_leaf = diff / scale, name
        loss_rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                    for k in m_cpu}
        ok = ok and max(loss_rel.values()) <= TRAIN_TOL[dname] \
            and _step_counts_ok(counts, 1)
        report[f"one_step_{dname}"] = {
            "loss_gpu": m_gpu, "loss_cpu": m_cpu, "loss_rel_err": loss_rel,
            "worst_grad_rel_err": worst, "worst_leaf": worst_leaf,
            "grad_rel_err_by_leaf": by_leaf, "launches": counts, "ok": ok}
        print(f"train one step {dname:9s} loss gpu={m_gpu['loss']:.6f} "
              f"cpu={m_cpu['loss']:.6f} worst grad rel err={worst:.3e} "
              f"({worst_leaf}) launches={counts} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"training one step {dname}: "
                            f"{report[f'one_step_{dname}']}")

    # --- five f32 steps, card against CPU
    cfg = train_cfg("float32")
    traj = {}
    for device, data, order in (("cpu", setup.data_cpu, setup.order_cpu),
                                (DEVICE, setup.data, setup.order)):
        model = setup.model(torch, cfg, device)
        opt = make_optimizer(cfg.train)
        run = make_superstep(get_model("MTAM"), cfg, opt, vocab, TRAIN_BATCH,
                             device=device)
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
    report["five_steps_float32"] = {
        "losses_gpu": traj[DEVICE][0].tolist(),
        "losses_cpu": traj["cpu"][0].tolist(), "loss_rel_err": loss_err,
        "param_max_abs_err": param_err, "ok": ok}
    print(f"train five f32 steps losses={traj[DEVICE][0].tolist()} "
          f"loss rel err={loss_err:.3e} param max abs err={param_err:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"training trajectory: {report['five_steps_float32']}")

    # --- the main path: K steps per dtype, timed
    main_launches = {}
    steps, warm = 20, 3      # per dtype; the order holds 48 steps
    for dname in ("bfloat16", "float32"):
        cfg = train_cfg(dname)
        model = setup.model(torch, cfg, DEVICE)
        opt = make_optimizer(cfg.train)
        run = make_superstep(get_model("MTAM"), cfg, opt, vocab, TRAIN_BATCH)
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
        for kname, by_mode in counts.items():
            for mode, n in by_mode.items():
                mode = None if kname == "dtable" else mode
                per = main_launches.setdefault(kname, {})
                per[mode] = per.get(mode, 0) + n
        busy = _device_busy(torch, lambda: run(
            model, state, setup.data, setup.order, warm + steps, 3))
        busy_ms = (None if busy["device_busy_ms"] is None
                   else busy["device_busy_ms"] / 3)
        losses = stacked["loss"].cpu()
        ok = _step_counts_ok(counts, steps) and bool(
            torch.isfinite(losses).all())
        report[f"timed_{dname}"] = {
            "steps": steps, "ms_per_step": ms,
            "examples_per_s": TRAIN_BATCH / ms * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / ms,
            "top_kernels": busy["top_kernels"][:5], "launches": counts,
            "losses": losses.tolist(), "ok": ok}
        r = report[f"timed_{dname}"]
        print(f"train {dname:9s} B={TRAIN_BATCH} ms/step={ms:.3f} "
              f"examples/s={r['examples_per_s']:.1f} device busy ms/step="
              f"{busy_ms} idle_share={r['idle_share']} launches/{steps} "
              f"steps={counts} {'ok' if ok else 'FAIL'}", flush=True)
        for name, kms in busy["top_kernels"][:5]:
            print(f"    {kms / 3:9.4f} ms/step  {name[:90]}", flush=True)
        if not ok:
            failures.append(f"training timed {dname}: launches {counts}")
    return report, main_launches


# ------------------------------------------------------------ report

def kernels_line(entries, main_launches):
    out = []
    for (kname, mode), by_dtype in entries.items():
        # serving and training both compute in bf16; dtable's head row is
        # the item table, the largest of its four shapes
        head = by_dtype["bfloat16"]
        out.append({
            "name": f"{kname}[{mode}]" if mode else kname, "route": "cuda",
            "source": KERNEL_FILES[kname][0],
            "replaces": KERNEL_FILES[kname][1],
            "launches": main_launches[kname][mode],
            "max_abs_err": max(r["max_abs_err"] for r in by_dtype.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # None where no single PyTorch call computes the function: the
            # time gate sits between QK^T and the softmax, and the GRU
            # cell's reset gate multiplies h before its product (cuDNN's
            # after) and the time gate scales the candidate (forward and
            # backward alike); dtable's is index_add_
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

    # phase 2b: the training step's kernels, at its shapes and ids
    setup = TrainSetup(torch)
    entries.update(check_train_kernels(torch, timer, 100, failures,
                                       setup.tables))

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

    # launches on the two main paths together
    main_launches = {k: dict(v) for k, v in serve_launches.items()}
    for kname, by_mode in train_launches.items():
        per = main_launches.setdefault(kname, {})
        for mode, n in by_mode.items():
            per[mode] = per.get(mode, 0) + n
    report = kernels_line(entries, main_launches)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build_s": build_s, **report,
                   "slice": slice_rows, "training": training,
                   "launches_serving": serve_launches,
                   "launches_training": {k: {str(m): n for m, n in v.items()}
                                         for k, v in train_launches.items()},
                   "failures": failures}, f, indent=1, default=str)
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
