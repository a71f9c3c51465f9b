"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- `nonbonded`: the dense pair kernel (csrc/nonbonded.cu), replacing
  torchmd_tpu/ops/pallas_nonbonded.py;
- `bonded`: the fused bonded kernel (csrc/bonded.cu), replacing
  torchmd_tpu/ops/pallas_bonded.py;
- `_build`: nvcc + ctypes build and load of the CUDA sources.

Nothing is compiled at import time: a kernel is built at its first launch.
"""
