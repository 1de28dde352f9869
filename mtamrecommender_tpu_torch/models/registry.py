"""experiment_type -> model dispatch (twin of
mtamrecommender_tpu/models/registry.py, for the models ported so far)."""

from __future__ import annotations

from typing import Dict

from mtamrecommender_tpu_torch.models import attention_models as att_m
from mtamrecommender_tpu_torch.models import mtam, rnn
from mtamrecommender_tpu_torch.models.base import ModelDef

MODEL_REGISTRY: Dict[str, ModelDef] = {
    # RNN baselines
    "Vallina_Gru4Rec": ModelDef("Vallina_Gru4Rec", rnn.init_vallina_gru4rec,
                                rnn.apply_vallina_gru4rec),
    "Gru4Rec": ModelDef("Gru4Rec", rnn.init_gru4rec, rnn.apply_gru4rec),
    "T_SeqRec": ModelDef("T_SeqRec", rnn.init_t_seqrec, rnn.apply_t_seqrec),
    # the proposed model + ablations
    "MTAM": ModelDef("MTAM", mtam.init_mtam, mtam.apply_mtam),
    "MTAM_no_time_aware_rnn": ModelDef(
        "MTAM_no_time_aware_rnn", mtam.init_mtam_no_time_rnn,
        mtam.apply_mtam_no_time_rnn),
    "MTAM_via_T_GRU": ModelDef("MTAM_via_T_GRU", mtam.init_mtam_via_t_gru,
                               mtam.apply_mtam_via_t_gru),
    "MTAM_via_rnn": ModelDef("MTAM_via_rnn", mtam.init_mtam_via_rnn,
                             mtam.apply_mtam_via_rnn),
    "MTAM_hybird": ModelDef("MTAM_hybird", mtam.init_mtam_hybird,
                            mtam.apply_mtam_hybird, "concat"),
    "T_GRU": ModelDef("T_GRU", mtam.init_t_gru, mtam.apply_t_gru),
    "MTAM_with_T_SeqRec": ModelDef(
        "MTAM_with_T_SeqRec", mtam.init_mtam_with_t_seqrec,
        mtam.apply_mtam_with_t_seqrec),
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
