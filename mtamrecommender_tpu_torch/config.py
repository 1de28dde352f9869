"""Typed experiment configuration with named presets.

Replaces the reference's mutable tf.flags singleton
(`config/model_parameter.py:6-73`) and its ~15 named
preset mutation blocks (`:75-396`) with frozen dataclasses.  CLI
overrides are applied through `with_overrides` instead of global flag
mutation, so configs are hashable and safe to close over in jit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + example-builder knobs.

    Mirrors the data-prep flags at model_parameter.py:45-64 and the
    builder behaviour of Prepare/prepare_data_base.py.
    """

    dataset: str = "ml_1m"            # reference FLAGS.type
    data_root: str = "data"
    max_seq_len: int = 50             # length_of_user_history
    gap_num: int = 6
    user_count_limit: int = 10_000
    causality: str = "unidirection"   # unidirection | random | time_window
    remove_duplicate: bool = True
    time_window_days: int = 35
    mask_rate: float = 0.2
    test_cap: int = 20_000            # prepare_data_base.py:195-196
    min_user_actions: int = 5         # Get_origin_data_base.filter min activity
    min_item_actions: int = 5
    user_sample_frac: float = 0.8     # get_origin_data_ml.py:28
    seed: int = 1234
    # synthetic generator knobs (used when dataset == "synthetic")
    synth_users: int = 2000
    synth_items: int = 3600
    synth_categories: int = 18
    synth_events_per_user: int = 40


@dataclass(frozen=True)
class ModelConfig:
    """Model family + tower dimensions (model_parameter.py:11-17,49)."""

    experiment_type: str = "MTAM"
    num_units: int = 128
    num_heads: int = 1
    num_blocks: int = 3
    dropout: float = 0.5
    regulation_rate: float = 5e-5
    pistrec_type: str = "soft"        # hard|soft|short|long|hybird
    time_gate_mode: str = "positional"  # decay-gate parameterization:
                                      # 'positional' — the reference's
                                      #   [Tq,Tk] position-indexed params
                                      #   (time_aware_attention.py:295-312,
                                      #   faithful; fixes the graph to one
                                      #   static sequence length);
                                      # 'scalar' — scalar gate params on
                                      #   scalar Δt (SURVEY.md §5.7): any
                                      #   length, blockwise/CP-shardable
    # numerics / kernel selection (TPU-native additions)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"    # flip to bfloat16 for MXU-heavy runs
    use_pallas: bool = False          # Pallas kernels vs. jnp reference path
    scan_unroll: int = 1              # recurrence-scan unroll factor
                                      # (scheduling only; math unchanged)
    pallas_scope: str = "all"         # which op families use_pallas covers:
                                      # 'all' or subset of 'gru,attention'
    # physical vocab-row padding: tables round up to a multiple so they
    # row-shard evenly over the model mesh axis and tile the 128-wide TPU
    # lane dim; logits past the logical vocab are masked (models/base.py)
    vocab_pad_multiple: int = 1
    # embedding-table backward: 'auto' (one-hot^T @ ct on the MXU for
    # tables <= ops.embedding.ONEHOT_BWD_MAX_VOCAB rows, XLA scatter-add
    # beyond), 'scatter', or 'onehot'.  TPU scatter-add is a serial
    # per-index loop and was the measured framework floor
    # (benchmarks/results/floor_r5.json); see ops/embedding.py
    embedding_grad_mode: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / loop cadence (model_parameter.py:24-39)."""

    optimizer: str = "adam"           # adadelta|adam|rmsprop|sgd
    learning_rate: float = 1e-3
    decay_rate: float = 0.995
    max_gradient_norm: float = 1.0
    train_batch_size: int = 256
    test_batch_size: int = 2048
    max_epochs: int = 200
    display_freq: int = 10
    eval_freq: int = 500
    save_freq: int = 50_000           # train_process.py:432
    steps_per_call: int = 1           # >1: scan K optimizer steps per jit
                                      # call on the device-resident path
                                      # (dispatch-latency amortization;
                                      # TPU-native addition, no reference
                                      # equivalent)
    flatten_optimizer: bool = False   # run clip+adam on ONE raveled param
                                      # vector (optax.flatten): collapses
                                      # the ~20-leaf per-step update chain
                                      # into a handful of ops — same math
                                      # (update parity pinned in tests),
                                      # different opt_state layout in
                                      # checkpoints.  Measured 20x SLOWER
                                      # (table copies); see
                                      # pack_small_leaves below instead
    pack_small_leaves: bool = False   # ravel only the SMALL float leaves
                                      # (~20 [d,d]/[d] mats, ~1 MB) into
                                      # one vector for the optimizer,
                                      # leaving the big embedding tables
                                      # standalone: ~24 per-leaf op
                                      # chains/step -> 5.  Same math;
                                      # update parity pinned in tests;
                                      # opt_state layout changes
    load_type: str = "from_scratch"   # from_scratch | full | fine_tune
    fine_tune_load_path: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    seed: int = 1234
    topk: Tuple[int, ...] = (1, 5, 10, 30, 50)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit/shard_map.

    data axis: batch sharding (DP); model axis: row-sharded embedding
    tables + vocab-parallel logits (EP/TP).  The reference has no
    parallelism at all (SURVEY.md section 2.6); this is the TPU-native
    replacement for its single-GPU tf.Session.
    """

    data_axis_size: int = -1          # -1: all remaining devices
    model_axis_size: int = 1
    data_axis_name: str = "data"
    model_axis_name: str = "model"
    shard_embeddings: bool = False    # row-shard tables over model axis
    context_parallel: bool = False    # shard the time-aware attention's
                                      # KEY axis over the model axis
                                      # (blockwise online-softmax exchange,
                                      # parallel/context_parallel.py);
                                      # requires model.time_gate_mode
                                      # == 'scalar' (SURVEY.md §5.7)
    embedding_engine: str = "gspmd"   # how sharded-table lookups execute:
                                      #   gspmd — sharding annotations only,
                                      #     XLA's partitioner picks the
                                      #     collectives;
                                      #   a2a   — explicit all-to-all ID
                                      #     exchange (shard_map engine,
                                      #     parallel/embedding_shard.py);
                                      #   psum  — explicit masked-gather +
                                      #     psum assemble


@dataclass(frozen=True)
class ExperimentConfig:
    version: str = "dev"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def with_overrides(self, **kv: Any) -> "ExperimentConfig":
        """Dotted-path overrides, e.g. with_overrides(**{"model.num_blocks": 8})."""
        out = self
        for key, value in kv.items():
            if "." in key:
                section, leaf = key.split(".", 1)
                sub = getattr(out, section)
                out = replace(out, **{section: replace(sub, **{leaf: value})})
            else:
                out = replace(out, **{key: value})
        return out

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _preset(version: str, dataset: str, experiment_type: str, num_blocks: int,
            num_heads: int = 1, **extra: Any) -> ExperimentConfig:
    """Shared shape of every training preset block in model_parameter.py:104-395."""
    cfg = ExperimentConfig(
        version=version,
        data=DataConfig(dataset=dataset, user_count_limit=1_000_000),
        model=ModelConfig(experiment_type=experiment_type,
                          num_blocks=num_blocks, num_heads=num_heads),
        train=TrainConfig(),
    )
    return cfg.with_overrides(**extra) if extra else cfg


# Named presets.  The reference presets are copy-pasted blocks selected by
# --experiment_name; we keep the same names (plus fixed variants) so runs
# remain comparable.  Note model_parameter.py:374-394 mislabels
# Time_Aware_Self_Attention_Modelb1_elec's experiment_type as
# MTAM_with_T_SeqRec; we preserve the label bug under the original name and
# add a *_fixed preset with the intended model.
_PRESETS: Dict[str, ExperimentConfig] = {
    "data_init": ExperimentConfig(
        version="tmall_init",
        data=DataConfig(dataset="taobaoapp", user_count_limit=80_000,
                        gap_num=15, remove_duplicate=False),
    ),
    "statistics": ExperimentConfig(
        version="beauty_statistics",
        data=DataConfig(dataset="beauty", user_count_limit=100_000_000, gap_num=15),
    ),
    "Ti_Self_Attention_Modelb3_beauty": _preset(
        "Ti_Self_Attention_Modelb3_beauty", "beauty", "Ti_Self_Attention_Model", 3),
    "STAMP_beauty": _preset("STAMP_beauty", "beauty", "STAMP", 6),
    "MTAM_via_rnnb6_beauty": _preset("MTAM_via_rnnb6_beauty", "beauty", "MTAM", 6),
    "Time_Aware_Self_Attention_Modelb3_yoochoose": _preset(
        "Time_Aware_Self_Attention_Modelb3_yoochoose", "yoochoose",
        "Time_Aware_Self_Attention_Model", 3),
    "MTAMb7_elec": _preset("MTAMb7_elec", "elec", "MTAM", 7),
    "MTAMb8_elec": _preset("MTAMb8_elec", "elec", "MTAM", 8),
    "MTAM_with_T_SeqRecb6_yoochoose": _preset(
        "MTAM_with_T_SeqRecb6_yoochoose", "yoochoose", "MTAM_with_T_SeqRec", 6),
    "MTAM_no_time_aware_attb7_music_256": _preset(
        "MTAM_no_time_aware_attb7_music_256", "music", "MTAM_no_time_aware_att", 7),
    "MTAM_with_T_SeqRecb7_music": _preset(
        "MTAM_with_T_SeqRecb7_music", "music", "MTAM_with_T_SeqRec", 7),
    "MTAM_via_rnnb7_music": _preset(
        "MTAM_via_rnnb7_music", "music", "MTAM_via_rnn", 7,
        **{"train.test_batch_size": 1500}),
    "Time_Aware_Self_Attention_Modelb3_music": _preset(
        "Time_Aware_Self_Attention_Modelb3_music", "music",
        "Time_Aware_Self_Attention_Model", 3),
    "Time_Aware_Self_Attention_Modelb2_elec": _preset(
        "Time_Aware_Self_Attention_Modelb2_elec", "elec",
        "Time_Aware_Self_Attention_Model", 2),
    # preserves the reference's experiment_type mislabel (see above)
    "Time_Aware_Self_Attention_Modelb1_elec": _preset(
        "Time_Aware_Self_Attention_Modelb1_elec", "elec", "MTAM_with_T_SeqRec", 1),
    "Time_Aware_Self_Attention_Modelb1_elec_fixed": _preset(
        "Time_Aware_Self_Attention_Modelb1_elec_fixed", "elec",
        "Time_Aware_Self_Attention_Model", 1),
    # TPU-native additions: CPU-runnable smoke preset + ml-1m MTAM headline run
    "bpr_ml1m": _preset("bpr_ml1m", "ml_1m", "bpr", 1),
    "MTAM_ml1m": _preset("MTAM_ml1m", "ml_1m", "MTAM", 3),
    "MTAM_synthetic": _preset("MTAM_synthetic", "synthetic", "MTAM", 3,
                              **{"data.user_count_limit": 10_000}),
}


def get_preset(name: str) -> ExperimentConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown experiment preset {name!r}; known: {sorted(_PRESETS)}")


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
