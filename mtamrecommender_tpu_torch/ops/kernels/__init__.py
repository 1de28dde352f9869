"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each wrapper module is named after its Pallas counterpart under
mtamrecommender_tpu/ops/pallas/.  A wrapper runs the plain twin for CPU
tensors and launches its kernel for CUDA tensors, with no fallback
between the two; `launches` counts kernel launches per mode.
"""
