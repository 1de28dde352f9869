"""GRU and the T-GRU decay cell (twin of mtamrecommender_tpu/ops/time_gru.py).

Every input-dependent projection is hoisted out of the recurrence into
one large matmul; the recurrence itself is `gru_scan_vjp`
(ops/kernels/gru_kernel.py): the `gru_scan` kernel forward and the
`gru_scan_bwd` kernel backward, or their plain twins on CPU tensors.
The port follows the JAX package's Pallas route (`_pallas_scan`): the
state is carried in f32 and the f32 outputs are cast back to the input
type.

T-GRU decay cell (TimeAwareGRUCell_decay_new):
  time_last_weight = relu(x*w_k1 + b_k1 + h*w_h1)
  time_last_score  = relu(w1*t_last + b1)
  time_last_state  = sigmoid(w_k2*weight + w12*score + b12)
  new_h            = u*h + (1-u)*c*time_last_state
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mtamrecommender_tpu_torch.ops import initializers as init
from mtamrecommender_tpu_torch.ops.kernels import gru_kernel
from mtamrecommender_tpu_torch.ops.layers import ParamModule

Params = Dict[str, torch.Tensor]


def init_gru(gen: torch.Generator, input_dim: int, units: int) -> Params:
    """TF GRUCell parameters with the [in+u, *] kernels split into x- and
    h-halves (each half cut from its own glorot draw over the full
    shape, as the JAX package does)."""
    return {
        "w_gate_x": init.glorot_uniform(gen, (input_dim + units, 2 * units))[:input_dim].clone(),
        "w_gate_h": init.glorot_uniform(gen, (input_dim + units, 2 * units))[input_dim:].clone(),
        "b_gate": torch.ones((2 * units,), device=gen.device),  # TF gate bias 1.0
        "w_cand_x": init.glorot_uniform(gen, (input_dim + units, units))[:input_dim].clone(),
        "w_cand_h": init.glorot_uniform(gen, (input_dim + units, units))[input_dim:].clone(),
        "b_cand": torch.zeros((units,), device=gen.device),
    }


def init_tgru(gen: torch.Generator, input_dim: int, units: int) -> Params:
    params = init_gru(gen, input_dim, units)
    for name in ("time_kernel_w1", "time_kernel_b1", "time_history_w1",
                 "time_w1", "time_w12", "time_b1", "time_b12",
                 "time_kernel_w2"):
        params[name] = init.glorot_uniform(gen, (units,))
    return params


class TimeGRU(ParamModule):
    """T-GRU ("new" cell) parameters: the GRU's w_gate_x/w_gate_h/b_gate/
    w_cand_x/w_cand_h/b_cand plus the per-unit time vectors."""


def tgru_net(p, inputs: torch.Tensor, time_last: torch.Tensor,
             time_now: torch.Tensor, lengths: torch.Tensor,
             initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MTAM's T-GRU decay cell over a packed sequence.

    inputs: [B, L, d]; time_last, time_now: [B, L]; lengths: [B].
    Returns [B, L, units] in the input type.  ``time_now`` enters the
    reference only through an input concat that the cell strips, so it
    does not enter the math."""
    del time_now
    batch = inputs.shape[0]
    units = p.b_cand.shape[0]
    gate_x = torch.matmul(inputs, p.w_gate_x)
    cand_x = torch.matmul(inputs, p.w_cand_x)
    # x*w_k1 + b_k1 and relu(w1*t_last + b1), precomputed for every step
    xw = inputs * p.time_kernel_w1 + p.time_kernel_b1
    score = torch.relu(p.time_w1 * time_last[..., None] + p.time_b1)
    h0 = (initial_state if initial_state is not None
          else torch.zeros((batch, units), dtype=inputs.dtype,
                           device=inputs.device))
    vecs = torch.stack([p.time_history_w1, p.time_kernel_w2, p.time_w12,
                        p.time_b12])
    out = gru_kernel.gru_scan_vjp(
        "tgru", gate_x, cand_x, xw, score, lengths.to(torch.int32), h0,
        p.w_gate_h, p.w_cand_h, p.b_gate, p.b_cand, vecs)
    return out.to(inputs.dtype)


def time_aware_gru_net(p, cell_type: str, inputs: torch.Tensor,
                       time_last: torch.Tensor, time_now: torch.Tensor,
                       lengths: torch.Tensor,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """GRU.time_aware_gru_net dispatch: 'new' -> the decay cell.  The
    'T-SeqRec' cell is not ported yet."""
    if cell_type == "new":
        return tgru_net(p, inputs, time_last, time_now, lengths,
                        initial_state)
    if cell_type == "T-SeqRec":
        raise NotImplementedError(
            "the T-SeqRec cell is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError(f"unknown time-aware cell type {cell_type!r}")
