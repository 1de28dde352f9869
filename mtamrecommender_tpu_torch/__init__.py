"""PyTorch/CUDA port of mtamrecommender_tpu, for one NVIDIA H100.

The JAX package `mtamrecommender_tpu` is the reference this package is
held against; the two share no code.  The layout mirrors the JAX
package module for module, so each port module sits where its
counterpart does.

What is ported so far is the serving path of MTAM
(`serve.Recommender.recommend`): collate -> embed -> T-GRU intent scan ->
time-gated attention hops -> layer norm -> full-catalog logits -> top-k.
Its two TPU kernels are hand-written CUDA C++ for sm_90a under `csrc/`,
built with nvcc at first use and bound with ctypes
(`ops/kernels/`).  On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs the plain PyTorch twin of the kernel.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mtamrecommender_tpu_torch.config import ExperimentConfig, get_preset  # noqa: F401
