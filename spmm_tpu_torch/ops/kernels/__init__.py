"""Hand-written CUDA kernels (`spmm_tpu_torch/csrc/`) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.  Importing builds nothing: the kernels are compiled
on first launch (`_build.library`).
"""
