"""The comparisons that decide `correct`, between what the timed path
produced and the plain reference (`benchmark.reference`).

A batched sampler call is followed step by step from the program's own
state, which its UNet forwards show: each forward's input is the state
x_k of step k (N * B rows) and its output the model's epsilon. For each
checked call:

- unet_gap: each recorded epsilon against the reference UNet on the same
  input and step;
- step_gap: x_0 against the benchmark's own draw x_T under the hard
  conditions that the reference works out from the problems' starts and
  goals; then x_{k+1} against the reference's step from x_k with the
  reference's epsilon and the benchmark's draw of step k (posterior mean,
  the guide's 20 iterations in the 14 guided steps, noise, hard
  conditions); and the call's returned chain against each state,
  unnormalized;
- final_gap: the returned smoothed samples against the reference's
  smoothing of its own last step, and the returned scores, free flags and
  best indices against the reference's finalize of the returned final
  samples (a flag or a best index that differs reads as an infinite gap;
  a best index only where the reference's two least scores differ by more
  than final_gap's limit).

The largest gap of each kind over the checked calls is compared with its
limit in the traffic file.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import finalize as ref_finalize
from benchmark.reference import no_tf32
from benchmark.reference import sampler as rs
from benchmark.reference.checkpoint import load_checkpoint
from benchmark.reference.scene import Scene
from benchmark.reference.unet import Unet


class Reference:
    """The reference's model, map, schedule and normalizer for one
    configuration, on `device`."""

    def __init__(self, cfg: Dict, model_dir: str, device):
        ck = load_checkpoint(model_dir)
        a = ck["args"]
        self.cfg = cfg
        self.device = torch.device(device)
        self.unet = Unet(ck["params"], a["dim_mults"], device)
        self.scene = Scene(cfg["boxes"], cfg["box_sizes"], device, *cfg["workspace"])
        self.sch = rs.schedule(a["n_diffusion_steps"], device=device)
        self.norm = rs.Normalizer(a["normalizer_mins"], a["normalizer_maxs"], device)
        self.mask = rs.hard_mask(cfg["horizon"], device)
        dt = cfg["trajectory_duration"] / cfg["horizon"]
        self.guide = {"margin": 1.1 * cfg["robot_radius"] + 0.01,
                      "w_collision": cfg["weight_collision"],
                      "w_smooth": cfg["weight_smoothness"],
                      "max_norm": cfg["max_grad_norm"], "dt": dt}
        n = cfg["n_diffusion_steps"]
        self.steps = list(range(n - 1, -cfg["n_diffusion_steps_without_noise"] - 1, -1))

    def values(self, starts, goals) -> torch.Tensor:
        return rs.hard_values(self.norm, torch.as_tensor(starts, device=self.device),
                              torch.as_tensor(goals, device=self.device), self.cfg["horizon"])


INF = float("inf")


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    if a.shape != b.shape:
        return INF
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_call(ref: Reference, kept: Dict, cells: List[int]) -> Dict[str, float]:
    """The gaps of one checked call. `kept` holds the problems (starts,
    goals), the draws (x_T (N, B, H, D), steps (S, N, B, H, D)), the
    recorded forwards [(x, t, eps)] and the returned PlanResult. The
    distinct cells that each guided step's iterations read are appended to
    `cells`."""
    cfg, dev = ref.cfg, ref.device
    x_T, draws = kept["x_T"].to(dev), kept["steps"].to(dev)
    N, B, H, D = x_T.shape
    values = ref.values(kept["starts"], kept["goals"])[:, None]          # (N, 1, H, D)
    fwd, res = kept["forwards"], kept["result"]
    if len(fwd) != len(ref.steps):
        return {"unet_gap": INF, "step_gap": INF, "final_gap": INF}
    chain = res.trajs_iters.to(dev)                                      # (N, S+1, B, H, D)
    unet = 0.0
    step = _gap(fwd[0][0].to(dev).reshape(N, B, H, D), rs.apply_hard(x_T, ref.mask, values))
    with torch.no_grad(), no_tf32():
        for k, i in enumerate(ref.steps):
            x, t, eps = (v.to(dev) for v in fwd[k])
            eps_ref = ref.unet(x, t)
            unet = max(unet, _gap(eps_ref, eps))
            step = max(step, _gap(ref.norm.unnormalize(x.reshape(N, B, H, D)), chain[:, k]))
            mean = rs.posterior_mean(ref.sch, x, eps_ref, max(i, 0)).reshape(N, B, H, D)
            if i < cfg["t_start_guide"]:
                keys: List[torch.Tensor] = []
                mean = rs.guide_loop(mean, ref.norm, ref.scene, ref.mask, values, ref.guide,
                                     cfg["n_guide_steps"], keys)
                cells.append(int(torch.unique(torch.cat(keys)).numel()))
            nxt = rs.apply_hard(rs.add_noise(ref.sch, mean, draws[k], i, cfg["noise_std_extra"]),
                                ref.mask, values)
            if k + 1 < len(fwd):
                step = max(step, _gap(nxt, fwd[k + 1][0].to(dev).reshape(N, B, H, D)))
        last = ref.norm.unnormalize(nxt)
        step = max(step, _gap(last, chain[:, -1]))
        own = ref_finalize.finalize(last, ref.scene, cfg["robot_radius"])
        fin = ref_finalize.finalize(chain[:, -1], ref.scene, cfg["robot_radius"])
    final = _gap(res.trajs_final.to(dev), own["smoothed"])
    free_p = res.free_mask.to(dev)
    if torch.equal(free_p, fin["free"]):
        final = max(final, _gap(torch.where(free_p, res.cost_all.to(dev), 0.0),
                                torch.where(free_p, fin["cost"], 0.0)))
        two = torch.topk(fin["cost"], 2, dim=-1, largest=False).values
        clear = ((two[:, 1] - two[:, 0]) > kept["tie"]) & fin["free"].any(-1)
        if bool(((res.idx_best.to(dev) != fin["best"]) & clear).any()):
            final = INF
    else:
        final = INF
    return {"unet_gap": unet, "step_gap": step, "final_gap": final}


def verdict(gaps: List[Dict[str, float]], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [largest reading, limit]} over the checked calls."""
    out = {}
    for name, limit in limits.items():
        vals = [g[name] for g in gaps if name in g]
        out[name] = [max(vals) if vals else INF, limit]
    return out
