"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- `nonbonded`: the dense pair kernel (csrc/nonbonded.cu), replacing
  torchmd_tpu/ops/pallas_nonbonded.py;
- `bonded`: the fused bonded kernel (csrc/bonded.cu), replacing
  torchmd_tpu/ops/pallas_bonded.py;
- `cell`: the cell-list pair kernel (csrc/cell.cu), replacing
  torchmd_tpu/ops/pallas_cell.py;
- `pme`: the PME spread and ik-gather kernels (csrc/pme.cu), replacing
  torchmd_tpu/ops/pallas_pme.py;
- `_build`: nvcc + ctypes build and load of the CUDA sources.

Nothing is compiled at import time: a kernel is built at its first launch.
"""
