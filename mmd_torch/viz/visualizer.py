"""Planning visualization: environment and robot trajectories, PNG and GIF.

Twin of `mmd_tpu/viz/visualizer.py` (reference: torch_robotics
visualizers/planning_visualizer.py:23-397): the env's boxes, per-robot
circles, trails, constraint overlays, the SDF and its gradient field, the
joint-space panels and GIF animations through matplotlib's FuncAnimation,
drawn with the JAX package's calls in its order, so that the same inputs
give the same pixels.

matplotlib is imported inside the functions that draw, never when this
module is imported: the card's machine has no matplotlib, and there a
render raises ImportError. The two fields (`sdf_field`, `grad_sdf_field`)
draw nothing: they read the env's grids through the lookup
(`mmd_torch.ops.sdf_kernel.grid_lookup`), the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from mmd_torch.ops.sdf_kernel import grid_lookup
from mmd_torch.utils.transfer import to_device


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("rendering needs matplotlib, which is not installed "
                          "on this machine") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def create_fig_and_axes(figsize=(6, 6)):
    fig, ax = pyplot().subplots(figsize=figsize)
    ax.set_aspect("equal")
    return fig, ax


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------- fields
def field_grid(limits, n: int):
    """The n x n grid over the workspace (X, Y of shape (n, n)) and its
    points (n^2, 2) float32, as the JAX renders build them."""
    lo, hi = np.asarray(limits[0]), np.asarray(limits[1])
    X, Y = np.meshgrid(np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n),
                       indexing="xy")
    return X, Y, np.stack([X.ravel(), Y.ravel()], -1).astype(np.float32)


def _lookup(scene, pts: np.ndarray):
    grid, extra = scene.grid, scene.extra_grid
    x = to_device(pts, grid.values.device)
    return grid_lookup(x, ((grid.values, grid.grads), (extra.values, extra.grads)),
                       grid.lower, grid.upper)


def sdf_field(scene, limits, n: int = 200) -> torch.Tensor:
    """The object grid's SDF at the n x n field points -> (n^2,), on the
    scene's device: one lookup."""
    vals, _ = _lookup(scene, field_grid(limits, n)[2])
    return vals[0]


def grad_sdf_field(scene, limits, n: int = 40) -> torch.Tensor:
    """The object grid's surrogate gradient at the n x n field points ->
    (n^2, 2), the floor cell's precomputed gradient, as the guide sees it
    through the lookup's backward: one lookup."""
    _, grads = _lookup(scene, field_grid(limits, n)[2])
    return grads[0]


class PlanningVisualizer:
    def __init__(self, task=None, env=None, robot_radius: float = 0.05):
        self.task = task
        if env is None and task is not None:
            env = getattr(task, "env", None)
        self.env = env
        self.robot_radius = (task.robot.radius if task is not None and
                             hasattr(task, "robot") else robot_radius)

    # ------------------------------------------------------------ rendering
    def render_env(self, ax, env=None, transform: Sequence[float] = (0.0, 0.0)):
        from matplotlib.patches import Rectangle

        env = env or self.env
        if env is None:
            return
        tx, ty = transform
        centers = _host(env.box_field.centers)
        halves = _host(env.box_field.half_sizes)
        for c, h in zip(centers, halves):
            ax.add_patch(Rectangle((c[0] - h[0] + tx, c[1] - h[1] + ty),
                                   2 * h[0], 2 * h[1], color="wheat", zorder=1))
        ax.set_xlim(env.limits[0][0] + tx - 0.05, env.limits[1][0] + tx + 0.05)
        ax.set_ylim(env.limits[0][1] + ty - 0.05, env.limits[1][1] + ty + 0.05)

    def render_tiled_env(self, ax, envs: List, transforms: np.ndarray):
        los, his = [], []
        for env, t in zip(envs, transforms):
            self.render_env(ax, env, t)
            los.append(env.limits[0] + t)
            his.append(env.limits[1] + t)
        lo = np.min(np.stack(los), axis=0)
        hi = np.max(np.stack(his), axis=0)
        ax.set_xlim(lo[0] - 0.05, hi[0] + 0.05)
        ax.set_ylim(lo[1] - 0.05, hi[1] + 0.05)

    def render_robot_trajectories(self, fig=None, ax=None, trajs=None,
                                  start_state=None, goal_state=None,
                                  colors=None, constraints_l=None,
                                  show_robot_in_image: bool = True, **kw):
        """trajs: (B, H, D): every trajectory, the robot's circle at its
        start (reference: planning_visualizer.py:37-77)."""
        from matplotlib.patches import Circle

        if ax is None:
            fig, ax = create_fig_and_axes()
            self.render_env(ax)
        trajs = _host(trajs)
        colors = colors or ["blue"] * len(trajs)
        for traj, color in zip(trajs, colors):
            ax.plot(traj[:, 0], traj[:, 1], color=color, alpha=0.5, lw=1.0, zorder=3)
            if show_robot_in_image:
                ax.add_patch(Circle(traj[0, :2], self.robot_radius,
                                    color=color, alpha=0.6, zorder=4))
        if start_state is not None:
            s = _host(start_state)
            ax.plot(s[0], s[1], "go", markersize=6, zorder=5)
        if goal_state is not None:
            g = _host(goal_state)
            ax.plot(g[0], g[1], "r*", markersize=9, zorder=5)
        if constraints_l:
            for c in constraints_l:
                for q, r in zip(c.q_l, c.radius_l):
                    ax.add_patch(Circle(_host(q)[:2], r, fill=False,
                                        color="red", ls="--", zorder=6))
        return fig, ax

    # ----------------------------------------------------- field rendering
    def render_env_sdf(self, ax=None, fig=None, n: int = 200):
        """Filled SDF contours over the workspace (reference:
        env_base.py:183-222 render_sdf), the field from `sdf_field`."""
        if ax is None:
            fig, ax = create_fig_and_axes()
        lo, hi = np.asarray(self.env.limits[0]), np.asarray(self.env.limits[1])
        X, Y, _ = field_grid(self.env.limits, n)
        sdf = _host(sdf_field(self.env.scene, self.env.limits, n)).reshape(X.shape)
        ctf = ax.contourf(X, Y, sdf)
        if fig is not None:
            fig.colorbar(ctf, orientation="vertical")
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_aspect("equal")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        return fig, ax

    def render_env_grad_sdf(self, ax=None, fig=None, n: int = 40):
        """Quiver of the SDF's surrogate gradient field, as the guide sees
        it (reference: env_base.py:225-264 render_grad_sdf), the field from
        `grad_sdf_field`."""
        if ax is None:
            fig, ax = create_fig_and_axes()
        X, Y, _ = field_grid(self.env.limits, n)
        grad = _host(grad_sdf_field(self.env.scene, self.env.limits, n))
        ax.quiver(X, Y, grad[:, 0].reshape(X.shape), grad[:, 1].reshape(X.shape),
                  color="red", scale=40, width=0.002, zorder=3)
        self.render_env(ax)
        ax.set_aspect("equal")
        return fig, ax

    # ------------------------------------------------------ joint-space plot
    def plot_joint_space_trajectories(self, trajs, free_mask=None,
                                      pos_start=None, pos_goal=None,
                                      q_min=None, q_max=None,
                                      output_fpath=None):
        """Per-dimension position and velocity against time, free
        trajectories blue and colliding ones red, joint limits dashed
        (reference: planning_visualizer.py:257-340).

        trajs: (B, H, D) with D = 2 q_dim; free_mask: (B,) bool or None.
        """
        plt = pyplot()
        trajs = _host(trajs)
        B, H, D = trajs.shape
        q_dim = D // 2
        free = (_host(free_mask).astype(bool) if free_mask is not None
                else np.ones(B, bool))
        fig, axs = plt.subplots(q_dim, 2, squeeze=False,
                                figsize=(9, 2.6 * q_dim))
        axs[0, 0].set_title("Position")
        axs[0, 1].set_title("Velocity")
        t = np.arange(H)
        for d in range(q_dim):
            for col, off in ((0, 0), (1, q_dim)):
                ax = axs[d, col]
                for b in range(B):
                    ax.plot(t, trajs[b, :, d + off],
                            color="blue" if free[b] else "red",
                            alpha=0.6 if free[b] else 0.25, lw=1.0)
                ax.set_ylabel(f"q{d}" if col == 0 else f"dq{d}")
                if col == 0:
                    if pos_start is not None:
                        ax.plot(0, _host(pos_start)[d], "go", ms=6)
                    if pos_goal is not None:
                        ax.plot(H - 1, _host(pos_goal)[d], "r*", ms=9)
                    if q_min is not None and q_max is not None:
                        ax.axhline(_host(q_min)[d], color="k", ls="--", lw=0.8)
                        ax.axhline(_host(q_max)[d], color="k", ls="--", lw=0.8)
        axs[-1, 0].set_xlabel("t")
        axs[-1, 1].set_xlabel("t")
        fig.tight_layout()
        if output_fpath:
            fig.savefig(output_fpath, dpi=150)
            plt.close(fig)
            return output_fpath
        return fig, axs

    # ------------------------------------------------------------ animation
    def animate_opt_iters(self, trajs_iters, idx_best=None, start_state=None,
                          goal_state=None, video_filepath="opt-iters.gif",
                          n_frames=10, anim_time=5.0):
        """Animate the denoising chain (S, B, H, D): frame k shows the batch
        at diffusion iteration k; the last frame marks the chosen
        trajectory (reference: planning_visualizer.py:225-255)."""
        plt = pyplot()
        from matplotlib import animation

        chain = _host(trajs_iters)
        S = chain.shape[0]
        n_frames = min(n_frames, S)
        idxs = np.round(np.linspace(0, S - 1, n_frames)).astype(int)

        fig, ax = create_fig_and_axes()

        def update(i):
            ax.clear()
            self.render_env(ax)
            ax.set_title(f"iter: {idxs[i]}/{S - 1}")
            self.render_robot_trajectories(fig=fig, ax=ax, trajs=chain[idxs[i]],
                                           start_state=start_state,
                                           goal_state=goal_state,
                                           show_robot_in_image=False)
            if i == n_frames - 1 and idx_best is not None:
                best = chain[-1, int(idx_best)]
                ax.plot(best[:, 0], best[:, 1], color="black", lw=2.0, zorder=7)
            return []

        anim = animation.FuncAnimation(fig, update, frames=n_frames,
                                       interval=1000 * anim_time / n_frames,
                                       blit=False)
        anim.save(video_filepath, writer=animation.PillowWriter(
            fps=max(1, int(n_frames / anim_time))))
        plt.close(fig)
        return video_filepath

    def animate_multi_robot_trajectories(self, trajs_l=None, start_state_l=None,
                                         goal_state_l=None, plot_trajs=True,
                                         video_filepath="robot-traj.gif",
                                         n_frames=None, anim_time=10.0,
                                         constraints=None, colors=None,
                                         envs=None, env_transforms=None, **kw):
        """trajs_l: one (H, D) (or (1, H, D)) path a robot -> GIF
        (reference: planning_visualizer.py:142-224)."""
        plt = pyplot()
        from matplotlib import animation
        from matplotlib.patches import Circle

        paths = [_host(t).reshape(-1, _host(t).shape[-1]) for t in trajs_l]
        T = max(len(p) for p in paths)
        n_frames = n_frames or min(T, 100)
        frame_ts = np.linspace(0, T - 1, n_frames).astype(int)
        if colors is None:
            cmap = plt.get_cmap("tab20")
            colors = [cmap(i / max(1, len(paths) - 1) if len(paths) > 1 else 0.0)
                      for i in range(len(paths))]

        fig, ax = create_fig_and_axes()
        if envs is not None and env_transforms is not None:
            self.render_tiled_env(ax, envs, env_transforms)
        else:
            self.render_env(ax)
        if plot_trajs:
            for p, c in zip(paths, colors):
                ax.plot(p[:, 0], p[:, 1], color=c, alpha=0.3, lw=1.0, zorder=2)
        for i, (s, g) in enumerate(zip(start_state_l or [], goal_state_l or [])):
            ax.plot(_host(s)[0], _host(s)[1], "o", color=colors[i],
                    markersize=4, zorder=3)
            ax.plot(_host(g)[0], _host(g)[1], "*", color=colors[i],
                    markersize=8, zorder=3)

        # Constraint keep-out overlays (reference: robot_planar_disk.py:109-167).
        for c in (constraints or []):
            for q, r in zip(getattr(c, "q_l", []), getattr(c, "radius_l", [])):
                ax.add_patch(Circle(_host(q)[:2], r, fill=False,
                                    color="red", ls="--", lw=0.8, zorder=6))

        trail_steps = int(kw.get("trail_steps", 12))
        circles, trails = [], []
        for p, c in zip(paths, colors):
            circle = Circle(p[0, :2], self.robot_radius, color=c, zorder=5)
            ax.add_patch(circle)
            circles.append(circle)
            (trail,) = ax.plot([], [], color=c, lw=2.0, alpha=0.8, zorder=4)
            trails.append(trail)

        def update(frame_i):
            t = frame_ts[frame_i]
            for circle, trail, p in zip(circles, trails, paths):
                ti = min(t, len(p) - 1)
                circle.center = p[ti, :2]
                seg = p[max(0, ti - trail_steps):ti + 1, :2]
                trail.set_data(seg[:, 0], seg[:, 1])
            return circles + trails

        anim = animation.FuncAnimation(fig, update, frames=n_frames,
                                       interval=1000 * anim_time / n_frames,
                                       blit=True)
        anim.save(video_filepath, writer=animation.PillowWriter(
            fps=max(1, int(n_frames / anim_time))))
        plt.close(fig)
        return video_filepath

    def save_frame(self, trajs_l, start_state_l=None, goal_state_l=None,
                   output_fpath="robot-traj.png", colors=None,
                   envs=None, env_transforms=None):
        plt = pyplot()
        from matplotlib.patches import Circle

        fig, ax = create_fig_and_axes()
        if envs is not None and env_transforms is not None:
            self.render_tiled_env(ax, envs, env_transforms)
        else:
            self.render_env(ax)
        if colors is None:
            cmap = plt.get_cmap("tab20")
            colors = [cmap(i / max(1, len(trajs_l) - 1) if len(trajs_l) > 1 else 0.0)
                      for i in range(len(trajs_l))]
        for i, t in enumerate(trajs_l):
            p = _host(t).reshape(-1, _host(t).shape[-1])
            ax.plot(p[:, 0], p[:, 1], color=colors[i], lw=1.5, zorder=3)
            ax.add_patch(Circle(p[0, :2], self.robot_radius, color=colors[i],
                                alpha=0.7, zorder=4))
        ax.axis("off")
        fig.savefig(output_fpath, dpi=100, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return output_fpath
