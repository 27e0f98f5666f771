"""mmd_torch: the MMD guided-diffusion planner in PyTorch, for one NVIDIA H100.

A port of `mmd_tpu` with the same module layout. It imports torch, numpy,
scipy and the standard library only; checkpoints and metadata are read by
its own readers (`mmd_torch.io`). Entry points run on `cuda` unless the
caller passes `device="cpu"`. The grid-SDF lookup runs as a hand-written
CUDA kernel on the card (`mmd_torch/csrc/grid_sdf.cu`) and as plain torch
on the CPU.
"""
