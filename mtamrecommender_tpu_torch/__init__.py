"""PyTorch/CUDA port of mtamrecommender_tpu, for one NVIDIA H100.

The JAX package `mtamrecommender_tpu` is the reference this package is
held against; the two share no code.  The layout mirrors the JAX
package module for module, so each port module sits where its
counterpart does.

Ported so far, for MTAM:
  * serving (`serve.Recommender.recommend`): collate -> embed -> T-GRU
    intent scan -> time-gated attention hops -> layer norm ->
    full-catalog logits -> top-k;
  * training (`train.trainer.make_train_step` / `make_superstep` over a
    `data.device_data` dataset): gather -> embed -> T-GRU -> hop-batched
    readout -> layer norm -> f32 softmax CE + L2 -> backward -> clipped
    Adam.
Their TPU kernels (the GRU scan and its backward, the time-gated
attention, the embedding-table backward) are hand-written CUDA C++ for
sm_90a under `csrc/`, built with nvcc at first use and bound with
ctypes (`ops/kernels/`).  On a CUDA tensor a wrapper launches its kernel
or raises; on a CPU tensor it runs the plain PyTorch twin of the kernel.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mtamrecommender_tpu_torch.config import ExperimentConfig, get_preset  # noqa: F401
