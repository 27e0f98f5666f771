"""The flagship forward, and the dry run of the port's parallel axes.

Twin of the JAX package's `__graft_entry__.py`. `entry()` gives the
flagship denoiser's forward and example inputs on the card.
`dryrun_multichip(n, backend, device)` runs one step of each program
whose axes the JAX dry run shards, on n spawned ranks
(`parallel.sharding.spawn`), at the JAX dry run's sizes (H = 16, UNet dim
8, dim_mults (1, 2)):
  1. a data-parallel train step: the global batch's rows on 'dp', the
     parameters on every rank, the gradients all-reduced to their mean
     (`train.trainer.train_step_dp`);
  2. the CBS root of an n-agent team with the agents on an 'agent' mesh
     (`parallel.team.plan_fresh_team`);
  3. the tile ensemble's sampling loop, min(n, 4) tiles on a 'tile' mesh
     of as many ranks, each holding its tiles' denoisers
     (`models.ensemble.ensemble_p_sample_loop`);
  4. for n >= 4, the team root on a 2-D ('agent', 'dp') mesh.
Every rank draws the whole step's draws from one seeded generator and
takes its share, as the JAX dry run's arrays are placed whole. It ends in
the line `dryrun_multichip OK on n ranks: ...` with the JAX dry run's
fields. Run it from the command line:

    python -m mmd_torch.parallel.dryrun --n 2 --backend gloo --device cuda
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.constraints import empty_constraint_set, stack_constraint_sets
from mmd_torch.costs.guide import GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset, endpoint_mask
from mmd_torch.envs.envs import SceneStack
from mmd_torch.models.diffusion import HardConds, SamplerNoise, draw_loss_noise
from mmd_torch.models.ensemble import CrossConds, ensemble_p_sample_loop, stack_params
from mmd_torch.models.schedules import make_schedule
from mmd_torch.models.temporal_unet import init_unet
from mmd_torch.parallel.sharding import make_mesh, spawn
from mmd_torch.parallel.team import PrioritizedTeam, plan_fresh_team
from mmd_torch.planners.single_agent.mpd import MPD
from mmd_torch.train.checkpoint import load_checkpoint
from mmd_torch.train.trainer import TrainConfig, TrainState, train_step_dp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_DIR = os.path.join(ROOT, "data_trained_models", "EnvEmptyNoWait2D-RobotPlanarDisk")
H, D, B_PER, UNET_DIM, DIM_MULTS = 16, 4, 2, 8, (1, 2)


def entry(device="cuda"):
    """(fn, example_args): the flagship checkpoint's denoiser forward, or a
    fresh init's where the checkpoint is absent, and a (64, 64, 4) batch
    with its (64,) steps, on `device`."""
    if os.path.isdir(FLAGSHIP_DIR):
        model, _, _ = load_checkpoint(FLAGSHIP_DIR, device=device)
    else:
        model = init_unet(torch.Generator().manual_seed(0), device=device)
    model.eval()

    @torch.no_grad()
    def fwd(x, t):
        return model(x, t)

    return fwd, (torch.zeros((64, 64, 4), device=device),
                 torch.zeros((64,), dtype=torch.int64, device=device))


def _team(model, schedule, dataset, cfg, n_agents: int, mesh):
    """n_agents planners across EnvEmpty2D's x axis, start and goal
    mirrored (the JAX dry run's team), sharing one program."""
    xs = np.linspace(-0.5, 0.5, n_agents)
    planners = [MPD(model, schedule, dataset, (xs[i], 0.0), (-xs[i], 0.0), cfg=cfg, seed=i)
                for i in range(n_agents)]
    return PrioritizedTeam.of(planners, planners[0].robot.rr_margin, mesh)


def dryrun_rank(rank: int, device: torch.device, n: int) -> dict:
    """One rank of `dryrun_multichip`: the four sections, each from the
    same draws on every rank."""
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_unet(torch.Generator().manual_seed(0), state_dim=D, unet_input_dim=UNET_DIM,
                      dim_mults=DIM_MULTS, device=device)
    schedule = make_schedule("exponential", 4, device=device)

    # 1. data-parallel train step
    dp = make_mesh([n], axis_names=("dp",))
    tcfg = TrainConfig(batch_size=B_PER * n, n_diffusion_steps=4)
    state = TrainState.create(model)
    batch = torch.zeros((B_PER * n, H, D), device=device)
    hard = HardConds(mask=endpoint_mask(H, device), values=batch)
    t, noise = draw_loss_noise(gen, batch, tcfg.n_diffusion_steps)
    loss = float(train_step_dp(state, state.model, schedule, tcfg, batch, hard, t, noise, dp))
    if not np.isfinite(loss):
        raise RuntimeError(f"the dp train step's loss is {loss}")

    # 2. the team root over the agent axis
    cfg = DiffusionConfig(horizon=H, state_dim=D, n_samples=4, n_diffusion_steps=3,
                          t_start_guide=2, n_guide_steps=2)
    normalizer = LimitsNormalizer.from_limits([-1, -1, -2, -2], [1, 1, 2, 2], device=device)
    dataset = TrajectoryDataset("EnvEmpty2D", H, D, normalizer, device=device)
    team = _team(state.ema, schedule, dataset, cfg, n, make_mesh([n], axis_names=("agent",)))
    root = plan_fresh_team(team, [SamplerNoise.draw(cfg, gen, device) for _ in range(n)])
    if tuple(root.trajs.shape) != (n, cfg.n_samples, H, D):
        raise RuntimeError(f"team plan of shape {tuple(root.trajs.shape)}")

    # 3. the tile ensemble over the tile axis
    n_tiles = min(n, 4)
    tile_mesh = make_mesh([n_tiles], axis_names=("tile",))
    tile_noise = SamplerNoise.draw(cfg, gen, device, n_tiles=n_tiles)  # on every rank
    tiles = None
    if tile_mesh.coords is not None:
        mask = torch.zeros((n_tiles, 1, H, 1), device=device)
        mask[0, 0, 0] = mask[-1, 0, H - 1] = 1.0
        hard_tiles = HardConds(mask=mask, values=torch.zeros((n_tiles, 1, H, D), device=device))
        gds = GuideData(scene=SceneStack((dataset.env.scene,) * n_tiles),
                        normalizer=LimitsNormalizer.stack([normalizer] * n_tiles),
                        constraints=stack_constraint_sets(
                            [empty_constraint_set(D, 1, device=device)] * n_tiles))
        cc = CrossConds.from_transforms([[2.0 * i, 0.0] for i in range(n_tiles)], D,
                                        device=device)
        x_tiles, _ = ensemble_p_sample_loop(
            stack_params([state.ema] * n_tiles), schedule, hard_tiles, cc, cfg, tile_noise,
            gds=gds, guide_cfg=team.p0.guide_cfg, mesh=tile_mesh)
        tiles = list(x_tiles.shape)
        if tiles != [n_tiles, cfg.n_samples, H, D]:
            raise RuntimeError(f"tile ensemble of shape {tiles}")

    # 4. the team root on a 2-D (agent, dp) mesh
    mesh2 = None
    if n >= 4:
        mesh2 = make_mesh(n, axis_names=("agent", "dp"))
        a2 = mesh2.shape["agent"]
        team2 = _team(state.ema, schedule, dataset, cfg, a2, mesh2)
        root2 = plan_fresh_team(team2, [SamplerNoise.draw(cfg, gen, device) for _ in range(a2)])
        if tuple(root2.trajs.shape) != (a2, cfg.n_samples, H, D):
            raise RuntimeError(f"2-D mesh team plan of shape {tuple(root2.trajs.shape)}")
        mesh2 = list(mesh2.devices.shape)
    return {"loss": loss, "team": list(root.trajs.shape), "team_trajs": root.trajs,
            "tiles": tiles, "mesh2": mesh2}


def dryrun_multichip(n: int, backend: str, device) -> list:
    """The four sections on n ranks of `backend` on `device` (module
    docstring); prints the OK line and returns each rank's results. Raises
    if a rank fails or the ranks' losses or team plans differ."""
    outs = spawn(dryrun_rank, n, backend, device, n)
    report(n, outs)
    return outs


def report(n: int, outs: list) -> None:
    """The n ranks' `dryrun_rank` results: raises if a rank's loss or team
    plan differs from rank 0's, else prints the OK line."""
    first = outs[0]
    for r, out in enumerate(outs[1:], 1):
        if out["loss"] != first["loss"] or not torch.equal(out["team_trajs"],
                                                           first["team_trajs"]):
            raise RuntimeError(f"rank {r}'s dry run differs from rank 0's")
    mesh2 = f", 2-D mesh {tuple(first['mesh2'])} team plan OK" if first["mesh2"] else ""
    print(f"dryrun_multichip OK on {n} ranks: dp train loss {first['loss']:.4f}, team plan "
          f"{tuple(first['team'])}, tile ensemble {tuple(first['tiles'])}{mesh2}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's multi-rank dry run")
    ap.add_argument("--n", type=int, required=True, help="ranks")
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"])
    ap.add_argument("--device", required=True, help="cuda or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
