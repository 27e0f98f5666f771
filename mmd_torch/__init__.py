"""mmd_torch: the MMD guided-diffusion planner in PyTorch, for one NVIDIA H100.

A port of `mmd_tpu` with the same module layout. It imports torch, numpy,
scipy and the standard library only; checkpoints and metadata are read and
written by its own readers and writers (`mmd_torch.io`). Entry points run on `cuda` unless the
caller passes `device="cpu"`. Ported so far: the single-robot MPD planner
(`planners.single_agent.mpd`), prioritized planning of a team
(`planners.multi_agent.prioritized_planning`), the CBS-family search
(`planners.multi_agent.cbs`), multi-tile planning
(`planners.single_agent.mpd_ensemble`), training (`train.trainer`,
with checkpoints both packages read, `train.checkpoint`), DDIM,
evaluation and data generation (`tools.eval_model`, `datagen`), the
experiment harness (`experiments`, the sweep launchers and
`tools.results_to_markdown`), the UNet's attention and context modes,
GP-prior sampling (`costs.gp`), the timers, profilers and FLOP accounting
of `utils` (the bench's `mfu_pct`), rendering (`viz`, which imports
matplotlib only when it draws) and the twins of the JAX package's scripts
under `tools`. Not ported: sharding a team over devices
(`parallel/sharding.py`, ROADMAP.md Queue 1). Three hand-written CUDA
kernels run on the card, the guide loop (`csrc/guide_loop.cu`: a guided
diffusion step's guide iterations in one launch), the collision guide
(`csrc/collision_guide.cu`) and the grid-SDF lookup (`csrc/grid_sdf.cu`);
CPU tensors take their plain torch versions.

Float32 stays float32 on the card in every entry point: importing the
package keeps cuDNN's convolutions and cuBLAS's matmuls out of TF32, so
that the card's float32 runs are the float32 of the JAX package's results
and of the port's CPU runs.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
