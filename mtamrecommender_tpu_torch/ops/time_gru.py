"""The GRU and the time-aware GRU cells (twin of
mtamrecommender_tpu/ops/time_gru.py).

Every input-dependent projection is hoisted out of the recurrence into
one large matmul; the recurrence itself is `gru_scan_vjp`
(ops/kernels/gru_kernel.py): the `gru_scan` kernel forward and the
`gru_scan_bwd` kernel backward, or their plain twins on CPU tensors.
The port follows the JAX package's Pallas route (`_pallas_scan`): the
state is carried in f32 and the f32 outputs are cast back to the input
type.  For t >= lengths the output is 0 and the state stays frozen.

Cells (and their `gru_scan` mode):
  plain GRU (plain): new_h = u*h + (1-u)*c
  T-SeqRec, TimeAwareGRUCell_sigmoid (tseqrec):
    new_h = u*h*sigmoid(time_now_state) + (1-u)*c*sigmoid(time_last_state)
    both time states depend on the inputs and the raw time features
    only, so both sigmoid planes are computed before the scan
  T-GRU decay cell, TimeAwareGRUCell_decay_new (tgru):
    time_last_weight = relu(x*w_k1 + b_k1 + h*w_h1)
    time_last_score  = relu(w1*t_last + b1)
    time_last_state  = sigmoid(w_k2*weight + w12*score + b12)
    new_h            = u*h + (1-u)*c*time_last_state
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

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


def init_bidirectional_gru(gen: torch.Generator, input_dim: int,
                           units: int) -> Dict[str, Params]:
    return {"fw": init_gru(gen, input_dim, units),
            "bw": init_gru(gen, input_dim, units)}


def init_tseqrec(gen: torch.Generator, input_dim: int, units: int) -> Params:
    """The GRU's parameters plus the T-SeqRec cell's time gates: per-unit
    vectors for the two time inputs, [d, u] and [u, u] kernels and a
    zero bias for each of the two time states."""
    params = init_gru(gen, input_dim, units)
    for name in ("time_input_w1", "time_input_b1", "time_input_w2",
                 "time_input_b2"):
        params[name] = init.glorot_uniform(gen, (units,))
    for i in ("1", "2"):
        params[f"time_kernel_w{i}"] = init.glorot_uniform(gen,
                                                          (input_dim, units))
        params[f"time_kernel_t{i}"] = init.glorot_uniform(gen, (units, units))
        params[f"time_bias{i}"] = torch.zeros((units,), device=gen.device)
    return params


def init_tgru(gen: torch.Generator, input_dim: int, units: int) -> Params:
    params = init_gru(gen, input_dim, units)
    for name in ("time_kernel_w1", "time_kernel_b1", "time_history_w1",
                 "time_w1", "time_w12", "time_b1", "time_b12",
                 "time_kernel_w2"):
        params[name] = init.glorot_uniform(gen, (units,))
    return params


def init_time_aware_gru(gen: torch.Generator, cell_type: str,
                        input_dim: int, units: int) -> Params:
    if cell_type == "T-SeqRec":
        return init_tseqrec(gen, input_dim, units)
    if cell_type == "new":
        return init_tgru(gen, input_dim, units)
    raise ValueError(f"unknown time-aware cell type {cell_type!r}")


class GRU(ParamModule):
    """Plain GRU parameters: w_gate_x, w_gate_h, b_gate, w_cand_x,
    w_cand_h, b_cand."""


class TimeGRU(ParamModule):
    """A time-aware cell's parameters ("new" or "T-SeqRec"): the GRU's
    plus the cell's time parameters."""


class BidirectionalGRU(nn.Module):
    """Two plain GRUs, ``fw.*`` and ``bw.*``."""

    def __init__(self, params: Dict[str, Params]):
        super().__init__()
        self.fw = GRU(params["fw"])
        self.bw = GRU(params["bw"])


def _zero_state(inputs: torch.Tensor, units: int,
                initial_state: Optional[torch.Tensor]) -> torch.Tensor:
    if initial_state is not None:
        return initial_state
    return torch.zeros((inputs.shape[0], units), dtype=inputs.dtype,
                       device=inputs.device)


def _scan(mode: str, p, gate_x, cand_x, e1, e2, lengths, h0,
          cell_vecs) -> torch.Tensor:
    out = gru_kernel.gru_scan_vjp(
        mode, gate_x, cand_x, e1, e2, lengths.to(torch.int32), h0,
        p.w_gate_h, p.w_cand_h, p.b_gate, p.b_cand, cell_vecs)
    return out.to(gate_x.dtype)


def gru_net(p, inputs: torch.Tensor, lengths: torch.Tensor,
            initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain GRU over a packed sequence (GRU.gru_net / gru_net_initial).
    inputs: [B, L, d_in]; lengths: [B].  Returns [B, L, units] in the
    input type.  The cell reads neither time plane nor cell vector, so
    they are zeros."""
    units = p.b_cand.shape[0]
    gate_x = torch.matmul(inputs, p.w_gate_x)
    cand_x = torch.matmul(inputs, p.w_cand_x)
    zeros = torch.zeros_like(cand_x)
    vecs = torch.zeros((4, units), dtype=gate_x.dtype, device=gate_x.device)
    return _scan("plain", p, gate_x, cand_x, zeros, zeros, lengths,
                 _zero_state(inputs, units, initial_state), vecs)


def bidirectional_gru_net(p, inputs: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """GRU.bidirectional_gru_net: concat(fw, bw) states, [B, L, 2u].
    The backward GRU runs over each row's valid prefix reversed (a row
    of length 0 is left as it is), and its outputs are reversed back."""
    fw = gru_net(p.fw, inputs, lengths)
    idx = torch.arange(inputs.shape[1], device=inputs.device)[None, :]
    lens = lengths.long()[:, None]
    rev = torch.where(idx < lens, lens - 1 - idx, idx)

    def reverse_valid(x):
        return torch.gather(x, 1, rev[:, :, None].expand(-1, -1, x.shape[2]))

    bw = reverse_valid(gru_net(p.bw, reverse_valid(inputs), lengths))
    return torch.cat([fw, bw], dim=-1)


def _tseqrec_time_states(p, inputs: torch.Tensor, time_last: torch.Tensor,
                         time_now: torch.Tensor):
    """sigmoid(time_now_state) and sigmoid(time_last_state) for every
    step: neither depends on the state."""
    now_in = torch.tanh(time_now[..., None] * p.time_input_w1
                        + p.time_input_b1)
    last_in = torch.tanh(time_last[..., None] * p.time_input_w2
                         + p.time_input_b2)
    now_state = (torch.matmul(inputs, p.time_kernel_w1)
                 + torch.matmul(now_in, p.time_kernel_t1) + p.time_bias1)
    last_state = (torch.matmul(inputs, p.time_kernel_w2)
                  + torch.matmul(last_in, p.time_kernel_t2) + p.time_bias2)
    return torch.sigmoid(now_state), torch.sigmoid(last_state)


def tseqrec_net(p, inputs: torch.Tensor, time_last: torch.Tensor,
                time_now: torch.Tensor, lengths: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """T-SeqRec (SLi-Rec style) time-aware GRU over a packed sequence.
    inputs: [B, L, d]; time_last, time_now: [B, L]; lengths: [B].
    Returns [B, L, units] in the input type.  The sigmoid planes enter
    the scan in the compute type, as the JAX package passes them."""
    units = p.b_cand.shape[0]
    sig_now, sig_last = _tseqrec_time_states(p, inputs, time_last, time_now)
    gate_x = torch.matmul(inputs, p.w_gate_x)
    cand_x = torch.matmul(inputs, p.w_cand_x)
    vecs = torch.zeros((4, units), dtype=gate_x.dtype, device=gate_x.device)
    return _scan("tseqrec", p, gate_x, cand_x, sig_now, sig_last, lengths,
                 _zero_state(inputs, units, initial_state), vecs)


def tgru_net(p, inputs: torch.Tensor, time_last: torch.Tensor,
             time_now: torch.Tensor, lengths: torch.Tensor,
             initial_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MTAM's T-GRU decay cell over a packed sequence.

    inputs: [B, L, d]; time_last, time_now: [B, L]; lengths: [B].
    Returns [B, L, units] in the input type.  ``time_now`` enters the
    reference only through an input concat that the cell strips, so it
    does not enter the math."""
    del time_now
    units = p.b_cand.shape[0]
    gate_x = torch.matmul(inputs, p.w_gate_x)
    cand_x = torch.matmul(inputs, p.w_cand_x)
    # x*w_k1 + b_k1 and relu(w1*t_last + b1), precomputed for every step
    xw = inputs * p.time_kernel_w1 + p.time_kernel_b1
    score = torch.relu(p.time_w1 * time_last[..., None] + p.time_b1)
    vecs = torch.stack([p.time_history_w1, p.time_kernel_w2, p.time_w12,
                        p.time_b12])
    return _scan("tgru", p, gate_x, cand_x, xw, score, lengths,
                 _zero_state(inputs, units, initial_state), vecs)


def time_aware_gru_net(p, cell_type: str, inputs: torch.Tensor,
                       time_last: torch.Tensor, time_now: torch.Tensor,
                       lengths: torch.Tensor,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """GRU.time_aware_gru_net dispatch: 'T-SeqRec' -> the sigmoid cell,
    'new' -> the decay cell."""
    if cell_type == "T-SeqRec":
        return tseqrec_net(p, inputs, time_last, time_now, lengths,
                           initial_state)
    if cell_type == "new":
        return tgru_net(p, inputs, time_last, time_now, lengths,
                        initial_state)
    raise ValueError(f"unknown time-aware cell type {cell_type!r}")
