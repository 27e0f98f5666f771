"""The port's renders (`mmd_torch.viz`) against the JAX package's
(`mmd_tpu/viz/visualizer.py`), and the renders wired into the trial, the
evaluation CLI, the training summary and CBS.

Both visualizers are called on the same paths; the SDF renders read the
same grids (JAX's, which differ from the port's own on a few tie-line
cells: ROADMAP.md Queue 3). The saved PNGs must be pixel-equal and so must
every GIF frame (decoded with matplotlib and Pillow). The fields the port
computes through its lookup must equal JAX's `grid_sdf` and its gradient
within 1e-6. These cases mirror tests/test_viz_and_misc.py:35-160.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg
from PIL import Image, ImageSequence

from mmd_tpu.common.constraints import MultiPointConstraint as JaxConstraint
from mmd_tpu.envs.envs import make_env as jax_make_env
from mmd_tpu.envs.grid_sdf import grid_sdf
from mmd_tpu.planners.multi_agent.cbs import CBS as JaxCBS
from mmd_tpu.tasks.task import make_task as jax_make_task
from mmd_tpu.viz.visualizer import PlanningVisualizer as JaxVisualizer
from mmd_torch.common.constraints import MultiPointConstraint
from mmd_torch.config import DiffusionConfig
from mmd_torch.envs.envs import ENV_REGISTRY, SceneData, make_env
from mmd_torch.envs.grid_sdf import GridSDF
from mmd_torch.planners.multi_agent.cbs import CBS
from mmd_torch.tasks.task import make_task
from mmd_torch.viz.visualizer import PlanningVisualizer, grad_sdf_field, sdf_field

torch.set_num_threads(1)

T = np.linspace(0, 1, 30, dtype=np.float32)[:, None]
P1 = np.concatenate([(-0.8 + 1.6 * T), np.full_like(T, -0.2)], axis=-1)
P2 = np.concatenate([(0.8 - 1.6 * T), np.full_like(T, 0.2)], axis=-1)


def png_equal(a, b):
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    return pa.shape == pb.shape and np.array_equal(pa, pb)


def gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(im)]


def gif_equal(a, b):
    fa, fb = gif_frames(a), gif_frames(b)
    return len(fa) == len(fb) > 1 and all(np.array_equal(x, y) for x, y in zip(fa, fb))


def torch_scene(scene) -> SceneData:
    def grid(g):
        return GridSDF(lower=tuple(np.asarray(g.lower).tolist()),
                       upper=tuple(np.asarray(g.upper).tolist()),
                       values=torch.from_numpy(np.array(g.values)),
                       grads=torch.from_numpy(np.array(g.grads)))
    return SceneData(grid=grid(scene.grid), extra_grid=grid(scene.extra_grid),
                     ws_min=torch.from_numpy(np.array(scene.ws_min)),
                     ws_max=torch.from_numpy(np.array(scene.ws_max)))


def env_on_jax_grids(name):
    """A port env of its own (not the cached one) reading JAX's grids."""
    env = ENV_REGISTRY[name](device="cpu")
    env.scene = torch_scene(jax_make_env(name).scene)
    return env


def test_frame_and_animation_are_pixel_equal(tmp_path):
    jv = JaxVisualizer(task=jax_make_task("EnvConveyor2D"))
    tv = PlanningVisualizer(task=make_task("EnvConveyor2D", "cpu"))
    args = ([P1, P2], [P1[0], P2[0]], [P1[-1], P2[-1]])
    assert png_equal(jv.save_frame(*args, output_fpath=str(tmp_path / "j.png")),
                     tv.save_frame(*args, output_fpath=str(tmp_path / "t.png")))
    kw = dict(trajs_l=[P1, P2], start_state_l=[P1[0], P2[0]], goal_state_l=[P1[-1], P2[-1]],
              n_frames=6, anim_time=1.0)
    assert gif_equal(jv.animate_multi_robot_trajectories(
        video_filepath=str(tmp_path / "j.gif"), **kw),
        tv.animate_multi_robot_trajectories(video_filepath=str(tmp_path / "t.gif"), **kw))


def test_tiled_env_frame_is_pixel_equal(tmp_path):
    names = ["EnvEmptyNoWait2D", "EnvConveyor2D"]
    transforms = np.array([[0.0, 0.0], [2.0, 0.0]], np.float32)
    path = np.concatenate([(-0.5 + 3.0 * T), np.zeros_like(T)], axis=-1)
    a = JaxVisualizer(robot_radius=0.05).save_frame(
        [path], output_fpath=str(tmp_path / "j.png"),
        envs=[jax_make_env(n) for n in names], env_transforms=transforms)
    b = PlanningVisualizer(robot_radius=0.05).save_frame(
        [torch.from_numpy(path)], output_fpath=str(tmp_path / "t.png"),
        envs=[make_env(n, "cpu") for n in names], env_transforms=transforms)
    assert png_equal(a, b)


@pytest.mark.parametrize("name", ["EnvConveyor2D", "EnvEmptyNoWait2D"])
def test_fields_match_jax_grid_sdf(name):
    env = env_on_jax_grids(name)
    grid = jax_make_env(name).scene.grid
    for n in (200, 40):
        lo, hi = env.limits
        X, Y = np.meshgrid(np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n))
        pts = jnp.asarray(np.stack([X.ravel(), Y.ravel()], -1), jnp.float32)
        want = np.asarray(grid_sdf(grid, pts))
        want_grad = np.asarray(jax.vmap(jax.grad(lambda p: grid_sdf(grid, p[None])[0]))(pts))
        np.testing.assert_allclose(sdf_field(env.scene, env.limits, n).numpy(), want,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(grad_sdf_field(env.scene, env.limits, n).numpy(), want_grad,
                                   rtol=0, atol=1e-6)


def test_sdf_and_gradient_renders_are_pixel_equal(tmp_path):
    jv = JaxVisualizer(env=jax_make_env("EnvConveyor2D"))
    tv = PlanningVisualizer(env=env_on_jax_grids("EnvConveyor2D"))
    for name, kw in (("render_env_sdf", {"n": 40}), ("render_env_grad_sdf", {"n": 10})):
        for who, viz in (("j", jv), ("t", tv)):
            fig, _ = getattr(viz, name)(**kw)
            fig.savefig(tmp_path / f"{who}_{name}.png")
        assert png_equal(tmp_path / f"j_{name}.png", tmp_path / f"t_{name}.png"), name


def test_joint_space_plot_is_pixel_equal(tmp_path):
    trajs = np.random.default_rng(0).normal(size=(6, 32, 4)).astype(np.float32)
    free = np.array([1, 0, 1, 1, 0, 1], bool)
    kw = dict(free_mask=free, pos_start=np.zeros(2), pos_goal=np.ones(2),
              q_min=np.array([-1, -1]), q_max=np.array([1, 1]))
    a = JaxVisualizer(env=jax_make_env("EnvEmpty2D")).plot_joint_space_trajectories(
        trajs, output_fpath=str(tmp_path / "j.png"), **kw)
    b = PlanningVisualizer(env=make_env("EnvEmpty2D", "cpu")).plot_joint_space_trajectories(
        torch.from_numpy(trajs), output_fpath=str(tmp_path / "t.png"),
        **{**kw, "free_mask": torch.from_numpy(free)})
    assert png_equal(a, b)


def test_denoising_chain_animation_is_pixel_equal(tmp_path):
    chain = np.random.default_rng(1).normal(size=(5, 4, 16, 4)).astype(np.float32) * 0.3
    kw = dict(idx_best=0, start_state=np.zeros(2), goal_state=np.ones(2) * 0.5, n_frames=3,
              anim_time=1.0)
    a = JaxVisualizer(env=jax_make_env("EnvEmpty2D")).animate_opt_iters(
        chain, video_filepath=str(tmp_path / "j.gif"), **kw)
    b = PlanningVisualizer(env=make_env("EnvEmpty2D", "cpu")).animate_opt_iters(
        torch.from_numpy(chain), video_filepath=str(tmp_path / "t.gif"), **kw)
    assert gif_equal(a, b)


def test_animation_trails_and_constraints_are_pixel_equal(tmp_path):
    t = np.linspace(0, 1, 20)[:, None].astype(np.float32)
    paths = [np.concatenate([t - 0.5, t * 0, t * 0, t * 0], -1),
             np.concatenate([t * 0, t - 0.5, t * 0, t * 0], -1)]
    out = []
    for who, viz, cls in (("j", JaxVisualizer(env=jax_make_env("EnvEmpty2D")), JaxConstraint),
                          ("t", PlanningVisualizer(env=make_env("EnvEmpty2D", "cpu")),
                           MultiPointConstraint)):
        c = cls(q_l=[np.zeros(2)], t_range_l=[(5, 10)], radius_l=[0.2])
        out.append(viz.animate_multi_robot_trajectories(
            trajs_l=paths, start_state_l=[p[0] for p in paths],
            goal_state_l=[p[-1] for p in paths], constraints=[c],
            video_filepath=str(tmp_path / f"{who}.gif"), n_frames=4, anim_time=1.0))
    assert gif_equal(*out)


def test_cbs_render_paths_png_and_gif_are_pixel_equal(tmp_path):
    """render_paths (JAX cbs.py:359-400) on stub searches: no planners."""
    t = np.linspace(0, 1, 16)[:, None].astype(np.float32)
    paths = [np.concatenate([t - 0.5, t * 0, t * 0, t * 0], -1),
             np.concatenate([0.5 - t, t * 0, t * 0, t * 0], -1)]
    starts = [np.array([-0.5, 0.0]), np.array([0.5, 0.0])]
    goals = [np.array([0.5, 0.0]), np.array([-0.5, 0.0])]
    out = {}
    for who, cls, task in (("j", JaxCBS, jax_make_task("EnvEmpty2D")),
                           ("t", CBS, make_task("EnvEmpty2D", "cpu"))):
        cbs = cls.__new__(cls)
        cbs.reference_task, cbs.start_state_pos_l, cbs.goal_state_pos_l = task, starts, goals
        out[who] = (cbs.render_paths(paths, animation_duration=0,
                                     output_fpath=str(tmp_path / f"{who}.gif")),
                    cbs.render_paths(paths, animation_duration=1.0, n_frames=3,
                                     output_fpath=str(tmp_path / f"{who}.gif")))
    assert out["t"][0].endswith(".png") and png_equal(out["j"][0], out["t"][0])
    assert gif_equal(out["j"][1], out["t"][1])


# ------------------------------------------------------- the wired renders
SHORT = DiffusionConfig(n_samples=8, n_diffusion_steps=8, t_start_guide=4, n_guide_steps=5)


@pytest.mark.parametrize("render_animation", [False, True])
def test_successful_trial_writes_its_frame(render_animation, tmp_path):
    from mmd_torch.experiments.experiments import (
        MultiAgentPlanningSingleTrialConfig,
        get_result_dir_from_trial_config,
    )
    from mmd_torch.experiments.problems import get_planning_problem
    from mmd_torch.experiments.status import TrialSuccessStatus
    from mmd_torch.experiments.trial import ModelRegistry, run_multi_agent_trial

    instance = "EnvEmptyNoWait2DRobotPlanarDiskCircle"
    cfg = MultiAgentPlanningSingleTrialConfig(
        time_str="t", num_agents=2, multi_agent_planner_class="PP", instance_name=instance,
        render_animation=render_animation)
    (cfg.start_state_pos_l, cfg.goal_state_pos_l, cfg.global_model_ids,
     cfg.agent_skeleton_l) = get_planning_problem(instance, 2)
    r = run_multi_agent_trial(cfg, ModelRegistry(device="cpu"), str(tmp_path),
                              diffusion_cfg=SHORT)
    assert r.success_status == TrialSuccessStatus.SUCCESS and r.jit_compile_time == 0.0
    d = get_result_dir_from_trial_config(cfg, "t", 0, root=str(tmp_path))
    files = set(os.listdir(d))
    assert "mmd_single_trial.png" in files
    assert ("mmd_single_trial.gif" in files) == render_animation
    # The frame is the visualizer's own, drawn from the saved paths.
    envs = [make_env("EnvEmptyNoWait2D", "cpu")]
    want = PlanningVisualizer(robot_radius=0.05).save_frame(
        r.agent_path_l, [np.asarray(s, np.float32) for s in r.start_state_pos_l],
        [np.asarray(g, np.float32) for g in r.goal_state_pos_l],
        output_fpath=str(tmp_path / "want.png"), envs=envs,
        env_transforms=np.zeros((1, 2), np.float32))
    assert png_equal(os.path.join(d, "mmd_single_trial.png"), want)


def test_eval_model_render_dir_writes_jaxs_file_set(tmp_path):
    from mmd_torch.tools.eval_model import evaluate

    out = tmp_path / "renders"
    row = evaluate("EnvEmptyNoWait2D", n_tasks=2, n_samples=8, device="cpu",
                   render_dir=str(out))
    assert row["success_rate"] == 1.0
    # scripts/eval_model.py:78-100: task_<i>.png for every task with a free
    # sample, and the first task's four deep renders.
    assert sorted(os.listdir(out)) == ["env_grad_sdf.png", "env_sdf.png", "joint_space.png",
                                       "opt_iters.gif", "task_0.png", "task_1.png"]
    assert len(gif_frames(out / "opt_iters.gif")) == 10


def test_summary_figure_is_written(tmp_path):
    from mmd_torch.datasets.trajectories import TrajectoryDataset, model_id
    from mmd_torch.models.schedules import make_schedule
    from mmd_torch.models.temporal_unet import init_unet
    from mmd_torch.train.summary import summary_trajectory_generation

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = TrajectoryDataset.load_trajectories(os.path.join(root, "data_trajectories"),
                                             model_id("EnvEmptyNoWait2D"), device="cpu")
    net = init_unet(torch.Generator().manual_seed(0), unet_input_dim=8, dim_mults=(1, 2),
                    device="cpu")
    stats = summary_trajectory_generation(net, make_schedule("exponential", 4, device="cpu"),
                                          ds, torch.Generator().manual_seed(1), n_samples=8,
                                          step=100, save_dir=str(tmp_path))
    assert 0.0 <= stats["fraction_free"] <= 1.0
    assert os.listdir(tmp_path) == ["summary_step_0000100.png"]
