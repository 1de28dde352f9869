"""Offline analysis figures (twin of mtamrecommender_tpu/utils/figures.py,
the reference's util/generate_figure.py).

From a checkpoint of the port's `train.checkpoint.Checkpointer`: (1) a
t-SNE of the item embeddings coloured by category, (2) per-user heatmaps
of the cosine similarity of each history's embeddings.  The numbers come
from the port: `generate_from_checkpoint` restores through
`serve.Recommender.from_checkpoint` on ``device`` (CUDA unless the
caller passes ``"cpu"``), embeds the test batch with `models.base.embed`
there and reads the item table from the restored model.  The t-SNE and
the PNGs are host work: ``sklearn`` and ``matplotlib`` are imported
inside the functions that need them, and the PNGs are skipped (their
paths None) where matplotlib is missing; the arrays are always returned.

    python -m mtamrecommender_tpu_torch.utils.figures \\
        --checkpoint data/check_point/run --type synthetic \\
        --experiment_type MTAM --out_dir data/figures
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


def item_embedding_tsne(item_table: np.ndarray, item_category: Dict[int, int],
                        max_items: int = 2000, seed: int = 0,
                        perplexity: float = 30.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """2-D t-SNE of the embeddings of the first ``max_items`` categorised
    items (by id) and their category labels."""
    from sklearn.manifold import TSNE

    ids = np.array(sorted(item_category))[:max_items]
    emb = np.asarray(item_table)[ids]
    labels = np.array([item_category[i] for i in ids])
    perplexity = min(perplexity, max(2.0, (len(ids) - 1) / 3.0))
    coords = TSNE(n_components=2, random_state=seed,
                  perplexity=perplexity, init="pca").fit_transform(emb)
    return coords, labels


def history_similarity_heatmap(behavior_emb: np.ndarray,
                               seq_len: int) -> np.ndarray:
    """[L, L] cosine-similarity matrix of one user's first ``seq_len``
    history embeddings."""
    e = np.asarray(behavior_emb)[:seq_len]
    norm = np.linalg.norm(e, axis=1, keepdims=True)
    e = e / np.maximum(norm, 1e-8)
    return e @ e.T


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without it."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def save_tsne_figure(coords: np.ndarray, labels: np.ndarray,
                     path: str) -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 8))
    scatter = ax.scatter(coords[:, 0], coords[:, 1], c=labels, cmap="tab20",
                         s=6, alpha=0.7)
    ax.set_title("item embeddings (t-SNE), colored by category")
    fig.colorbar(scatter, ax=ax, label="category")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_heatmap_figure(matrix: np.ndarray, path: str) -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, cmap="viridis")
    ax.set_xlabel("history position")
    ax.set_ylabel("history position")
    fig.colorbar(im, ax=ax)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def heatmap_arrays(rec, test_batch, user_rows: int = 4):
    """The history heatmaps of the first ``user_rows`` rows of
    ``test_batch``: `models.base.embed` of the restored (f32) model on
    its device, then `history_similarity_heatmap` of each row's
    behaviour embeddings up to its ``seq_len``."""
    import torch

    from mtamrecommender_tpu_torch.models import base

    batch = type(test_batch)(*(t.to(rec.device) for t in test_batch))
    with torch.no_grad():
        be = base.embed(rec.model, batch).behavior_emb.float().cpu().numpy()
    sl = batch.seq_len.cpu().numpy()
    return [history_similarity_heatmap(be[b], int(sl[b]))
            for b in range(min(user_rows, be.shape[0]))]


def generate_from_checkpoint(cfg, meta, item_category: Dict[int, int],
                             checkpoint_dir: str, out_dir: str,
                             test_batch=None, user_rows: int = 4,
                             max_items: int = 2000, device=None):
    """Restore the latest checkpoint under ``checkpoint_dir`` on
    ``device`` (`serve.Recommender.from_checkpoint`, without a trainer)
    and render the t-SNE figure and, given a packed test batch, the
    first ``user_rows`` history heatmaps.  Returns ``(arrays, paths)``;
    a path is None where matplotlib is missing."""
    from mtamrecommender_tpu_torch.serve import Recommender

    rec = Recommender.from_checkpoint(cfg, meta, checkpoint_dir,
                                      device=device)
    item_table = rec.model.embedding.item_table.detach().float().cpu().numpy()
    coords, labels = item_embedding_tsne(item_table, item_category,
                                         max_items=max_items)
    paths = {"tsne": save_tsne_figure(
        coords, labels, os.path.join(out_dir, "item_tsne.png"))}
    arrays = {"tsne_coords": coords, "tsne_labels": labels, "heatmaps": []}
    if test_batch is not None:
        arrays["heatmaps"] = heatmap_arrays(rec, test_batch, user_rows)
        for b, hm in enumerate(arrays["heatmaps"]):
            paths[f"heatmap_{b}"] = save_heatmap_figure(
                hm, os.path.join(out_dir, f"history_heatmap_{b}.png"))
    return arrays, paths


def config_from_json(path: str):
    """An `ExperimentConfig` from a ``cfg.to_dict()`` JSON dump."""
    import json

    from mtamrecommender_tpu_torch.config import (DataConfig,
                                                  ExperimentConfig,
                                                  MeshConfig, ModelConfig,
                                                  TrainConfig)
    with open(path) as f:
        d = json.load(f)
    d["train"]["topk"] = tuple(d["train"].get("topk", (1, 5, 10, 30, 50)))
    return ExperimentConfig(
        version=d.get("version", "dev"), data=DataConfig(**d["data"]),
        model=ModelConfig(**d["model"]), train=TrainConfig(**d["train"]),
        mesh=MeshConfig(**d.get("mesh", {})))


def main(argv=None) -> int:
    """Restore a checkpoint and render the analysis figures; every flag
    that sets a parameter's shape (the gate, the heads, the vocab
    padding) must match the run's, or ``--config_json`` gives the run's
    resolved config whole."""
    import argparse

    from mtamrecommender_tpu_torch.config import ExperimentConfig
    from mtamrecommender_tpu_torch.data.ingest import load_origin_data
    from mtamrecommender_tpu_torch.data.pipeline import (batch_iterator,
                                                         pack_examples)
    from mtamrecommender_tpu_torch.data.prepare import prepare_examples

    ap = argparse.ArgumentParser(
        prog="mtamrecommender_tpu_torch.utils.figures")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--type", default="synthetic", dest="dataset")
    ap.add_argument("--experiment_type", default="MTAM")
    ap.add_argument("--out_dir", default="data/figures")
    ap.add_argument("--num_units", type=int, default=128)
    ap.add_argument("--num_blocks", type=int, default=3)
    ap.add_argument("--max_seq_len", type=int, default=50)
    ap.add_argument("--time_gate_mode", default="positional",
                    choices=["positional", "scalar"])
    ap.add_argument("--num_heads", type=int, default=1)
    ap.add_argument("--vocab_pad_multiple", type=int, default=1)
    ap.add_argument("--config_json", default=None,
                    help="path to a cfg.to_dict() JSON dump of the run's "
                         "resolved config; overrides the individual flags")
    ap.add_argument("--heatmap_users", type=int, default=4)
    ap.add_argument("--max_items", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to restore and embed on (default "
                         "cuda)")
    args = ap.parse_args(argv)

    if args.config_json:
        cfg = config_from_json(args.config_json)
    else:
        cfg = ExperimentConfig().with_overrides(**{
            "data.dataset": args.dataset, "data.max_seq_len": args.max_seq_len,
            "model.experiment_type": args.experiment_type,
            "model.num_units": args.num_units,
            "model.num_blocks": args.num_blocks,
            "model.time_gate_mode": args.time_gate_mode,
            "model.num_heads": args.num_heads,
            "model.vocab_pad_multiple": args.vocab_pad_multiple})
    origin = load_origin_data(cfg.data)
    prepared = prepare_examples(origin, cfg.data)
    test = pack_examples(prepared.test_set, prepared.meta)
    _, batch = next(batch_iterator(test, max(args.heatmap_users, 1)))
    _, paths = generate_from_checkpoint(
        cfg, prepared.meta, prepared.item_category, args.checkpoint,
        args.out_dir, test_batch=batch, user_rows=args.heatmap_users,
        max_items=args.max_items, device=args.device)
    for name, p in paths.items():
        print(f"{name}: {p if p else '(matplotlib unavailable - array only)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
