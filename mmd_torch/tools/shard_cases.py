"""The sharded programs' cases, run by the ranks of `parallel.sharding.spawn`.

A spawned rank imports the function it runs by name, so the port's tests
and `chip_smoke.py` keep their rank functions here, beside the builders
that the unsharded side of each comparison shares with them:
- `team_planners`: the circle team on EnvEmptyNoWait2D, on the committed
  checkpoint or on a small UNet's given weights;
- `team_root`: the CBS root (`plan_fresh_team`) of such a team, with the
  kernels' launches it made;
- `dp_steps`: train steps of a small UNet on given draws, data-parallel
  over a 'dp' mesh (`train_step_dp`) or not;
- `tile_loop`: the tile ensemble's sampling loop on given draws, over a
  'tile' mesh or not;
- `searches`: CBS-family searches of the circle team, each on its mesh;
- `sharding_case`, `root_case`, `search_case`, `chip_case`: what one
  rank runs.
Every rank draws nothing of its own: the draws are given, or drawn from a
seeded generator that every rank seeds alike.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from mmd_torch.common.multi_agent_utils import get_start_goal_pos_circle
from mmd_torch.config import DiffusionConfig
from mmd_torch.costs.constraints import empty_constraint_set, stack_constraint_sets
from mmd_torch.costs.guide import GuideConfig, GuideData
from mmd_torch.datasets.normalization import LimitsNormalizer
from mmd_torch.datasets.trajectories import TrajectoryDataset
from mmd_torch.envs.envs import SceneStack, make_env
from mmd_torch.io.flat_yaml import load_flat_yaml
from mmd_torch.models.diffusion import HardConds, SamplerNoise
from mmd_torch.models.ensemble import CrossConds, ensemble_p_sample_loop, stack_params
from mmd_torch.models.schedules import make_schedule
from mmd_torch.models.temporal_unet import TemporalUnet
from mmd_torch.parallel import dryrun
from mmd_torch.parallel.sharding import (
    gather_leading_axis,
    make_mesh,
    shard_axes,
    shard_leading_axis,
)
from mmd_torch.parallel.team import PrioritizedTeam, plan_fresh_team
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.planners.single_agent.mpd import MPD, load_planners
from mmd_torch.tools.row_chunked import RowChunked
from mmd_torch.train.trainer import TrainConfig, TrainState, train_step, train_step_dp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODELS = os.path.join(ROOT, "data_trained_models")
DATA = os.path.join(ROOT, "data_trajectories")
ENV = "EnvEmptyNoWait2D"
MID = f"{ENV}-RobotPlanarDisk"


def launches() -> dict:
    """Every kernel's launches so far in this process, by kernel."""
    from mmd_torch.ops.collision_guide import collision_guide
    from mmd_torch.ops.guide_loop import guide_loop_cuda
    from mmd_torch.ops.sdf_kernel import grid_lookup

    return {"guide_loop": guide_loop_cuda.launches, "collision_guide": collision_guide.launches,
            "grid_sdf_lookup": grid_lookup.launches}


def small_unet(weights: dict, device) -> TemporalUnet:
    """A TemporalUnet of weights["unet_dim"] x weights["dim_mults"] holding
    weights["state_dict"] (JAX's parameters through `convert_flax_params`)."""
    model = TemporalUnet(state_dim=4, unet_input_dim=weights["unet_dim"],
                         dim_mults=tuple(weights["dim_mults"]))
    model.load_state_dict(weights["state_dict"])
    return model.to(device).eval()


def team_planners(device, n_agents: int, radius: float = 0.8, n_samples: Optional[int] = None,
                  bf16: bool = False, weights: Optional[dict] = None,
                  cfg: Optional[DiffusionConfig] = None, unet_rows: Optional[int] = None):
    """(planners, starts, goals): one MPD per agent of the n-agent circle
    on EnvEmptyNoWait2D, planner i seeded i, all on one program. The
    committed checkpoint's model and schedule (its bf16 twin with `bf16`),
    or with `weights` a small UNet (`small_unet`) and an exponential
    schedule of weights["n_steps"]; the checkpoint's normalizer either
    way. `cfg` replaces the planners' config, n_samples its batch. With
    `unet_rows` the UNet runs that many rows at a time (`RowChunked`):
    then a call's arithmetic does not depend on how many problems it
    holds, as a convolution's float32 sums do on the CPU and in cuDNN."""
    starts, goals = get_start_goal_pos_circle(n_agents, radius=radius)
    if weights is None:
        planners = load_planners(MODELS, DATA, ENV, starts, goals, device=device, bf16=bf16)
    else:
        info = load_flat_yaml(os.path.join(MODELS, MID, "args.yaml"))
        normalizer = LimitsNormalizer.from_limits(info["normalizer_mins"],
                                                  info["normalizer_maxs"], device=device)
        dataset = TrajectoryDataset.load(DATA, MID, normalizer, device=device)
        model = small_unet(weights, device)
        schedule = make_schedule("exponential", weights["n_steps"], device=device)
        planners = [MPD(model, schedule, dataset, s, g, cfg=cfg, seed=i)
                    for i, (s, g) in enumerate(zip(starts, goals))]
    chunked = None if unet_rows is None else RowChunked(planners[0].model, unet_rows)
    for p in planners:
        if cfg is not None:
            p.cfg = cfg
        if n_samples is not None:
            p.cfg = dataclasses.replace(p.cfg, n_samples=n_samples)
        if chunked is not None:
            p.model = chunked
    return planners, starts, goals


def _on(noise_l: Sequence[SamplerNoise], device) -> list:
    return [SamplerNoise(x_T=z.x_T.to(device), steps=z.steps.to(device)) for z in noise_l]


def team_root(device, team: dict, noise=None, noise_seed: Optional[int] = None,
              mesh=None) -> dict:
    """The CBS root of `team_planners(device, **team)` on the draws
    `noise` (one SamplerNoise an agent) or on draws from a generator on
    `device` seeded noise_seed, under `mesh`: its plans, free masks, chosen
    indices and summary, and the kernels' launches it made."""
    planners, _, _ = team_planners(device, **team)
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        noise = [SamplerNoise.draw(p.cfg, gen, device) for p in planners]
    before = launches()
    out = plan_fresh_team(PrioritizedTeam.of(planners, planners[0].robot.rr_margin, mesh),
                          _on(noise, device))
    counts = {k: v - before[k] for k, v in launches().items()}
    return {"trajs": out.trajs, "free_mask": out.free_mask, "ix": out.ix,
            "summary": list(out.summary), "launches": counts}


def dp_steps(device, spec: dict, mesh=None) -> dict:
    """len(spec["steps"]) train steps of `small_unet(spec)` on the given
    (batch, t, noise) draws, each batch its own hard conditions' values
    under spec["mask"]: data-parallel over the mesh's 'dp' axis, or
    `train_step` without a mesh. Returns the losses, parameters, EMA and
    Adam's first moments (which, unlike Adam's steps, scale with the
    gradients)."""
    model = small_unet(spec, device).train()
    schedule = make_schedule("exponential", spec["n_steps"], device=device)
    cfg = TrainConfig(**spec["train"])
    state = TrainState.create(model)
    mask = spec["mask"].to(device)
    losses = []
    for batch, t, noise in spec["steps"]:
        batch, t, noise = batch.to(device), t.to(device), noise.to(device)
        hard = HardConds(mask=mask, values=batch)
        if mesh is None:
            loss = train_step(state, model, schedule, cfg, batch, hard, t, noise)
        else:
            loss = train_step_dp(state, model, schedule, cfg, batch, hard, t, noise, mesh)
        losses.append(float(loss))
    names = [n for n, _ in model.named_parameters()]
    return {"losses": losses, "params": model.state_dict(), "ema": state.ema.state_dict(),
            "mu": dict(zip(names, state.mu))}


def tile_loop(device, spec: dict, mesh=None):
    """The tile ensemble's loop (`ensemble_p_sample_loop`) of one small
    UNet a tile (spec["tiles"], each a `small_unet` spec) on map
    spec["env"] with empty constraints, tiles at spec["transforms"], the
    first tile's start and the last tile's goal held, on the draws
    spec["noise"]: over the mesh's 'tile' axis, or not. Returns (x, chain)."""
    cfg, T = spec["cfg"], len(spec["tiles"])
    H, D = cfg.horizon, cfg.state_dim
    model = stack_params([small_unet(w, device) for w in spec["tiles"]])
    schedule = make_schedule("exponential", spec["n_steps"], device=device)
    mask = torch.zeros((T, 1, H, 1), device=device)
    mask[0, 0, 0] = mask[-1, 0, H - 1] = 1.0
    values = torch.zeros((T, 1, H, D), device=device)
    values[0, 0, 0, :2] = torch.as_tensor(spec["start"], device=device)
    values[-1, 0, H - 1, :2] = torch.as_tensor(spec["goal"], device=device)
    normalizer = LimitsNormalizer.from_limits(*spec["limits"], device=device)
    gds = GuideData(scene=SceneStack((make_env(spec["env"], device).scene,) * T),
                    normalizer=LimitsNormalizer.stack([normalizer] * T),
                    constraints=stack_constraint_sets(
                        [empty_constraint_set(4, 1, device=device)] * T))
    cc = CrossConds.from_transforms(spec["transforms"], D, device=device)
    noise = spec["noise"]
    return ensemble_p_sample_loop(
        model, schedule, HardConds(mask=mask, values=values), cc, cfg,
        SamplerNoise(x_T=noise.x_T.to(device), steps=noise.steps.to(device)), gds=gds,
        guide_cfg=GuideConfig(), mesh=mesh)


def searches(device, runs: Sequence[dict]) -> list:
    """Each run: a CBS-family search of `team_planners(device,
    **run["team"])` (fresh planners, so each run draws alike) with
    run["search"] as CBS's knobs, on make_mesh(run["mesh"], run["axes"])
    where run["mesh"] is given. Returns per run its paths (A, H, D), the
    expansions, status, conflicts, sampler calls, kernel launches, wall
    seconds and the root's seconds waiting on the device."""
    out = []
    for run in runs:
        mesh = make_mesh(run["mesh"], axis_names=run["axes"]) if run.get("mesh") else None
        planners, starts, goals = team_planners(device, **run["team"])
        team = CBS(planners, starts, goals, mesh=mesh, **run["search"])
        before = launches()  # after the construction's start and goal checks
        paths, n_exp, status, n_conflicts = team.plan(runtime_limit=run.get("limit", 600))
        out.append({"paths": torch.as_tensor(np.stack(paths)), "n_exp": n_exp,
                    "status": str(status), "n_conflicts": n_conflicts,
                    "calls": (team.timing["sampler_calls"] - team.timing["sampler_calls_local"],
                              team.timing["sampler_calls_local"]),
                    "launches": {k: v - before[k] for k, v in launches().items()},
                    "plan_s": team.timing["plan_s"],
                    "root_wait_s": team.timing.get("device_root_s", 0.0)})
    return out


def sharding_case(rank: int, device, spec: dict) -> dict:
    """One rank of tests/test_torch_sharding.py's spawn (4 ranks): the
    helpers' shards and gathers and make_mesh's shapes and errors; the team
    root over a 4-rank 'agent' mesh; the dp steps over a 4-rank 'dp' mesh;
    the tile loop over a 2-rank 'tile' mesh (ranks 0 and 1)."""
    out = {}
    agent = make_mesh([4], axis_names=("agent",))
    x = torch.arange(48, dtype=torch.float32).reshape(16, 3)
    part = shard_leading_axis(x, agent, "agent")
    out["agent_part"], out["agent_whole"] = part, gather_leading_axis(part, agent, "agent")
    grid = make_mesh([2, 2], axis_names=("agent", "dp"))
    y = torch.arange(192, dtype=torch.float32).reshape(8, 12, 2)
    block = shard_axes(y, grid, ("agent", "dp"))
    cols = gather_leading_axis(block.transpose(0, 1), grid, "dp").transpose(0, 1)
    out["grid_block"], out["grid_whole"] = block, gather_leading_axis(cols, grid, "agent")
    out["shapes"] = [make_mesh(4).shape, list(make_mesh(4, ("agent", "dp")).devices.shape),
                     agent.shape, grid.shape, agent.coords, grid.coords]
    errors = []
    for shape, names in (([4, 4], ("agent", "dp")), ([4], ("agent", "dp")), ([8], ("dp",))):
        try:
            make_mesh(shape, axis_names=names)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    out["root"] = team_root(device, spec["team"], noise=spec["noise"], mesh=agent)
    out["dp"] = dp_steps(device, spec["dp"], make_mesh([4], axis_names=("dp",)))
    tile = make_mesh([2], axis_names=("tile",))
    if tile.coords is not None:
        out["tiles"] = tile_loop(device, spec["tiles"], tile)
    return out


def root_case(rank: int, device, spec: dict) -> dict:
    """One rank's team root on make_mesh(spec["mesh"], spec["axes"])
    (`team_root` with spec's team and draws)."""
    mesh = make_mesh(spec["mesh"], axis_names=spec["axes"])
    return team_root(device, spec["team"], noise=spec.get("noise"),
                     noise_seed=spec.get("noise_seed"), mesh=mesh)


def search_case(rank: int, device, runs: Sequence[dict]) -> list:
    """One rank's `searches`."""
    return searches(device, runs)


def chip_case(rank: int, device, spec: dict) -> dict:
    """One rank of chip_smoke.py's phase 19: `root_case` of spec["root"],
    `searches` of spec["runs"], then the dry run's rank on spec["dryrun"]
    ranks (`parallel.dryrun.dryrun_rank`), in one spawn."""
    return {"root": root_case(rank, device, spec["root"]),
            "runs": searches(device, spec["runs"]),
            "dryrun": dryrun.dryrun_rank(rank, device, spec["dryrun"])}
