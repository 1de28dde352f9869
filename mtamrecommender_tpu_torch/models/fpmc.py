"""FPMC: factorized personalized Markov chain (twin of
mtamrecommender_tpu/models/fpmc.py).

Scoring keeps the reference's math (compute_x, FPMC.py:36-40):

    x(u, i | basket) = VUI[u] . VIU[i] + mean_{l in basket} VIL[i] . VLI[l]

The reference trains it with per-example SBPR-SGD (learn_epoch:70-98);
as in the JAX package, the same objective is a batched step over (user,
positive, negative, basket) tuples: autograd, then SGD on all four
tables.  `evaluate` is the reference's `evaluation` (FPMC.py:47-68):
top-1 accuracy and MRR.  The model runs no kernel.  Its entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from mtamrecommender_tpu_torch.ops.layers import ParamModule
from mtamrecommender_tpu_torch.types import resolve_device

TABLES = ("VUI", "VIU", "VIL", "VLI")


class FPMCConfig(NamedTuple):
    n_user: int
    n_item: int
    n_factor: int = 32
    learn_rate: float = 0.01
    regular: float = 0.001
    init_std: float = 0.01


class FPMC(ParamModule):
    """The four factor tables: ``VUI`` [n_user, f], ``VIU``, ``VIL``,
    ``VLI`` [n_item, f]."""


def init_fpmc(gen: torch.Generator, cfg: FPMCConfig) -> FPMC:
    """The tables from N(0, init_std^2), on the generator's device."""
    shapes = {"VUI": cfg.n_user, "VIU": cfg.n_item, "VIL": cfg.n_item,
              "VLI": cfg.n_item}
    return FPMC({name: cfg.init_std * torch.randn(
        (shapes[name], cfg.n_factor), generator=gen, device=gen.device)
        for name in TABLES})


def _mean_basket(table: torch.Tensor, basket: torch.Tensor,
                 basket_mask: torch.Tensor) -> torch.Tensor:
    """The mean of ``table``'s rows over each basket's live slots: [B, f]."""
    denom = basket_mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    rows = table[basket.long()]                            # [B, K, f]
    return (rows * basket_mask[:, :, None]).sum(dim=1) / denom


def score_all(model: FPMC, u: torch.Tensor, basket: torch.Tensor,
              basket_mask: torch.Tensor) -> torch.Tensor:
    """compute_x_batch (FPMC.py:42-45) for every item: [B, n_item]."""
    former = torch.matmul(model.VUI[u.long()], model.VIU.T)
    latter = torch.matmul(_mean_basket(model.VLI, basket, basket_mask),
                          model.VIL.T)
    return former + latter


def sbpr_loss(model: FPMC, u, i, j, basket, basket_mask,
              regular: float) -> torch.Tensor:
    """-mean(log sigmoid(x(u, i) - x(u, j))) + regular * the squared sum
    of all four tables (the JAX package's `_sbpr_loss`)."""
    vui = model.VUI[u.long()]
    vli = model.VLI[basket.long()]                         # [B, K, f]
    denom = basket_mask.sum(dim=1).clamp(min=1.0)

    def x(item):
        vil = model.VIL[item.long()]
        acc = (torch.einsum("bf,bkf->bk", vil, vli) * basket_mask
               ).sum(dim=1) / denom
        return (vui * model.VIU[item.long()]).sum(dim=1) + acc

    rank_loss = -torch.log(torch.sigmoid(x(i) - x(j))).mean()
    reg = regular * sum(p.square().sum() for p in model.parameters())
    return rank_loss + reg


def sbpr_step(model: FPMC, u, i, j, basket, basket_mask, *,
              learn_rate: float, regular: float) -> torch.Tensor:
    """One SBPR step: the loss's gradient by autograd, then p -= lr * g on
    all four tables in place.  Returns the loss (before the update)."""
    model.zero_grad(set_to_none=True)
    loss = sbpr_loss(model, u, i, j, basket, basket_mask, regular)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(p.grad, alpha=-learn_rate)
    return loss.detach()


def evaluate(model: FPMC, data: Sequence) -> Tuple[float, float]:
    """FPMC.evaluation (FPMC.py:47-68): top-1 accuracy and MRR over (u,
    i, basket) tuples; the two products on the tables' device, the ranks
    on the host."""
    if not data:
        return 0.0, 0.0
    with torch.no_grad():
        vui_viu = torch.matmul(model.VUI, model.VIU.T).cpu().numpy()
        vil_vli = torch.matmul(model.VIL, model.VLI.T).cpu().numpy()
    correct, rr = 0, []
    for (u, i, b_tm1) in data:
        scores = vui_viu[u] + np.mean(vil_vli[:, b_tm1], axis=1)
        if i == int(scores.argmax()):
            correct += 1
        rr.append(1.0 / (int(np.sum(scores > scores[i])) + 1))
    return correct / len(rr), float(sum(rr) / len(rr))


def pack_batch(tr_data: Sequence, sel: np.ndarray, basket_cap: int):
    """(u, i, basket, mask) numpy arrays of the tuples ``sel``: baskets cut
    to ``basket_cap`` and zero-padded, the mask 1 on their live slots."""
    u = np.array([tr_data[k][0] for k in sel], np.int32)
    i = np.array([tr_data[k][1] for k in sel], np.int32)
    basket = np.zeros((len(sel), basket_cap), np.int32)
    mask = np.zeros((len(sel), basket_cap), np.float32)
    for r, k in enumerate(sel):
        b = tr_data[k][2][:basket_cap]
        basket[r, :len(b)] = b
        mask[r, :len(b)] = 1.0
    return u, i, basket, mask


def train_fpmc(cfg: FPMCConfig, tr_data: Sequence, te_data=None, *,
               n_epoch: int = 10, neg_batch_size: int = 10,
               batch_size: int = 256, basket_cap: int = 50,
               seed: int = 1234, device=None
               ) -> Tuple[FPMC, Tuple[float, float]]:
    """learnSBPR_FPMC (FPMC.py:100-127) with batched steps, as the JAX
    package's `train_fpmc`: the order and the negatives come from numpy's
    ``RandomState(seed)`` in the same sequence; the tables from a
    generator seeded with ``seed`` (the JAX package draws them with its
    own PRNG, so the two start from different tables).  ``tr_data``: (u,
    i, basket) tuples.  Runs on CUDA unless ``device="cpu"``."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    model = init_fpmc(torch.Generator(device=device).manual_seed(seed), cfg)
    n = len(tr_data)
    for _ in range(n_epoch):
        order = rng.randint(0, n, size=n)  # random.choice with replacement
        for lo in range(0, n, batch_size):
            sel = order[lo:lo + batch_size]
            if len(sel) == 0:
                continue
            u, i, basket, mask = (torch.from_numpy(a).to(device) for a in
                                  pack_batch(tr_data, sel, basket_cap))
            for _neg in range(neg_batch_size):
                j = torch.from_numpy(rng.randint(0, cfg.n_item, size=len(sel))
                                     .astype(np.int32)).to(device)
                sbpr_step(model, u, i, j, basket, mask,
                          learn_rate=cfg.learn_rate, regular=cfg.regular)
    result = evaluate(model, te_data) if te_data is not None else (0.0, 0.0)
    return model, result
