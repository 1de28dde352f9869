"""experiment_type -> model dispatch (twin of
mtamrecommender_tpu/models/registry.py, for the models ported so far)."""

from __future__ import annotations

from typing import Dict

from mtamrecommender_tpu_torch.models import attention_models as att_m
from mtamrecommender_tpu_torch.models import mtam
from mtamrecommender_tpu_torch.models.base import ModelDef

MODEL_REGISTRY: Dict[str, ModelDef] = {
    "MTAM": ModelDef("MTAM", mtam.init_mtam, mtam.apply_mtam),
    # attention baselines
    "SASrec": ModelDef("SASrec", att_m.init_sasrec, att_m.apply_sasrec),
    "Time_Aware_Self_Attention_Model": ModelDef(
        "Time_Aware_Self_Attention_Model", att_m.init_time_aware_sa,
        att_m.apply_time_aware_sa),
    "Ti_Self_Attention_Model": ModelDef(
        "Ti_Self_Attention_Model", att_m.init_tisas, att_m.apply_tisas),
}


def get_model(experiment_type: str) -> ModelDef:
    try:
        return MODEL_REGISTRY[experiment_type]
    except KeyError:
        raise KeyError(
            f"experiment_type {experiment_type!r} is not in the PyTorch port; "
            f"ported: {sorted(MODEL_REGISTRY)}.  The rest of the JAX "
            "package's model zoo is queued in ROADMAP.md") from None
