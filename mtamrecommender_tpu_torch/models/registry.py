"""experiment_type -> model dispatch (twin of
mtamrecommender_tpu/models/registry.py): all 22 entries, with the JAX
package's names and output modes.  The NARM family and MTAM_hybird
route through the concat output head, bpr through the bpr loss; the
rest score directly against the item table."""

from __future__ import annotations

from typing import Dict

from mtamrecommender_tpu_torch.models import attention_models as att_m
from mtamrecommender_tpu_torch.models import (bprmf, hybrid, mtam, pistrec,
                                              rnn)
from mtamrecommender_tpu_torch.models.base import ModelDef

MODEL_REGISTRY: Dict[str, ModelDef] = {
    # RNN baselines
    "Vallina_Gru4Rec": ModelDef("Vallina_Gru4Rec", rnn.init_vallina_gru4rec,
                                rnn.apply_vallina_gru4rec),
    "Gru4Rec": ModelDef("Gru4Rec", rnn.init_gru4rec, rnn.apply_gru4rec),
    "T_SeqRec": ModelDef("T_SeqRec", rnn.init_t_seqrec, rnn.apply_t_seqrec),
    # hybrid baselines
    "NARM": ModelDef("NARM", hybrid.init_narm, hybrid.apply_narm, "concat"),
    "NARM+": ModelDef("NARM+", hybrid.init_narm_time_att,
                      hybrid.apply_narm_time_att, "concat"),
    "NARM++": ModelDef("NARM++", hybrid.init_narm_time_att_time_rnn,
                       hybrid.apply_narm_time_att_time_rnn, "concat"),
    "LSTUR": ModelDef("LSTUR", hybrid.init_lstur, hybrid.apply_lstur),
    "LSTUR_time_rnn": ModelDef("LSTUR_time_rnn", hybrid.init_lstur_time_rnn,
                               hybrid.apply_lstur_time_rnn),
    "STAMP": ModelDef("STAMP", hybrid.init_stamp, hybrid.apply_stamp),
    # the proposed model + ablations
    "MTAM": ModelDef("MTAM", mtam.init_mtam, mtam.apply_mtam),
    "MTAM_no_time_aware_rnn": ModelDef(
        "MTAM_no_time_aware_rnn", mtam.init_mtam_no_time_rnn,
        mtam.apply_mtam_no_time_rnn),
    "MTAM_no_time_aware_att": ModelDef(
        "MTAM_no_time_aware_att", mtam.init_mtam_no_time_att,
        mtam.apply_mtam_no_time_att),
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
    # matrix factorization
    "bpr": ModelDef("bpr", bprmf.init_bprmf, bprmf.apply_bprmf, "bpr"),
    # PISTRec switch network
    "pistrec": ModelDef("pistrec", pistrec.init_pistrec,
                        pistrec.apply_pistrec),
}


def get_model(experiment_type: str) -> ModelDef:
    try:
        return MODEL_REGISTRY[experiment_type]
    except KeyError:
        raise KeyError(f"unknown experiment_type {experiment_type!r}; "
                       f"known: {sorted(MODEL_REGISTRY)}") from None
