"""PyTorch/CUDA port of mtamrecommender_tpu, for one NVIDIA H100.

The JAX package `mtamrecommender_tpu` is the reference this package is
held against; the two share no code.  The layout mirrors the JAX
package module for module, so each port module sits where its
counterpart does.

Ported so far:
  * MTAM serving (`serve.Recommender.recommend`): collate -> embed ->
    T-GRU intent scan -> time-gated attention hops -> layer norm ->
    full-catalog logits -> top-k;
  * MTAM training (`train.trainer.make_train_step` / `make_superstep`
    over a `data.device_data` dataset): gather -> embed -> T-GRU ->
    hop-batched readout -> layer norm -> f32 softmax CE + L2 ->
    backward -> clipped Adam;
  * the self-attention models SASrec, Time_Aware_Self_Attention_Model
    and Ti_Self_Attention_Model, training and serving through the same
    entry points: embed -> self-attention blocks (plain, time-gated or
    log-interval-biased, with attention-weight dropout in training) ->
    gather -> layer norm;
  * MTAM over long histories (256 <= L <= 1024), training and serving:
    the whole multi-hop readout, projections included, in one fused
    readout kernel per direction;
  * the rest of the registry (`models.registry`, all 22 entries: the
    MTAM ablations, the RNN and hybrid baselines, PISTRec and BPRMF)
    through the same entry points, FPMC (`models.fpmc`) and the TopPop /
    P-Pop floors (`models.top_pop`);
  * the command line end to end (`python -m mtamrecommender_tpu_torch`,
    `cli`, and the experiment fleet, `fleet`): a raw or generated log
    (`data.ingest`, numpy columns, no pandas) -> examples (the native
    builder `data.fastprep` over native/fastprep.cpp, or `data.prepare`
    with its cache) -> `train.trainer.Trainer` (adam, adadelta, rmsprop,
    sgd; evaluation, checkpoints and exact resume on its cadence).
Their TPU kernels (the GRU scan and its backward, the fused attention
and its backward, the embedding-table backward, the fused multi-hop
readout and its backward) are hand-written CUDA
C++ for sm_90a under `csrc/`, built with nvcc at first use and bound
with ctypes (`ops/kernels/`).  On a CUDA tensor a wrapper launches its kernel
or raises; on a CPU tensor it runs the plain PyTorch twin of the kernel.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mtamrecommender_tpu_torch.config import ExperimentConfig, get_preset  # noqa: F401
