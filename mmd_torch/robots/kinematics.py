"""Forward kinematics of articulated robots, batched over configurations.

Twin of `mmd_tpu/robots/kinematics.py` (reference: deps/torch_robotics/
torch_robotics/torch_kinematics_tree/models/robot_tree.py:75-492). A robot
is a frozen record of stacked joint tensors with a static topology
(parents, joint types, dof map); `fk` composes the fixed origin
transforms with each joint's motion, for any leading batch of
configurations (JAX vmaps a single-configuration `fk`).

Conventions, as in JAX:
- joint j attaches link j to link parents[j] (parents[j] < j, -1 = base);
- origins[j] is the constant parent-link -> joint frame SE(3) transform;
- a revolute or prismatic joint moves about or along axes[j] (a unit
  vector of the joint frame) by q[dof_index[j]]; a fixed joint has
  dof_index -1;
- world transform of link j = world[parents[j]] @ origins[j] @ motion_j.

Collision geometry is the reference's sphere model (robot_base.py:59-142):
sphere s is rigidly attached to link coll_link[s] at coll_offset[s].

Jacobians are analytic: a revolute joint moves a point p of its subtree
by axis_w x (p - o_w), a prismatic one by axis_w, with axis_w and o_w the
joint's world axis and origin (JAX takes `jax.jacfwd` of `fk`; the two
agree to float32 rounding). GPMP2's collision factor for an arm
(`arm_clearances_and_jacobian`) takes the clearances' derivatives in the
sphere centers by autograd through the lookup (its floor-cell gradient,
with JAX's rules at ties) and chains them with the spheres' Jacobians.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mmd_torch.envs.grid_sdf import grid_sdf_pair, linspace_f32
from mmd_torch.utils.transfer import to_device

REVOLUTE, PRISMATIC, FIXED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Stacked-tensor articulated robot with a static topology."""

    origins: torch.Tensor       # (J, 4, 4) fixed parent -> joint transforms
    axes: torch.Tensor          # (J, 3) unit joint axes (joint frame)
    q_min: torch.Tensor         # (DOF,)
    q_max: torch.Tensor         # (DOF,)
    coll_link: torch.Tensor     # (S,) int64 link of each collision sphere
    coll_offset: torch.Tensor   # (S, 3) sphere center in its link's frame
    coll_radius: torch.Tensor   # (S,) sphere radii
    # (J, J): 1 where joint j lies on the chain from the base to link l
    # (l included), on the device, so that a Jacobian needs no host copy.
    on_chain: torch.Tensor
    parents: Tuple[int, ...] = ()
    types: Tuple[int, ...] = ()
    dof_index: Tuple[int, ...] = ()

    @property
    def n_links(self) -> int:
        return len(self.parents)

    @property
    def n_dof(self) -> int:
        return self.q_min.shape[0]


def _rodrigues(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation about a unit axis (3,) by theta (...,) -> (..., 3, 3)."""
    kx, ky, kz = axis[0], axis[1], axis[2]
    zero = torch.zeros((), dtype=axis.dtype, device=axis.device)
    K = torch.stack([torch.stack([zero, -kz, ky]), torch.stack([kz, zero, -kx]),
                     torch.stack([-ky, kx, zero])])
    s, c = torch.sin(theta)[..., None, None], torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) and (..., 3) -> (..., 4, 4)."""
    bottom = torch.zeros((*R.shape[:-2], 1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3:].fill_(1.0)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def _joint_motion(tree: KinematicTree, j: int, q: torch.Tensor) -> torch.Tensor:
    """Joint j's SE(3) motion at configurations q (..., DOF) -> (..., 4, 4)."""
    qj = q[..., tree.dof_index[j]]
    if tree.types[j] == REVOLUTE:
        return _homogeneous(_rodrigues(tree.axes[j], qj),
                            torch.zeros((*q.shape[:-1], 3), dtype=q.dtype, device=q.device))
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    return _homogeneous(eye, tree.axes[j] * qj[..., None])  # PRISMATIC


def fk(tree: KinematicTree, q: torch.Tensor) -> torch.Tensor:
    """World SE(3) transforms of every link: q (..., DOF) -> (..., J, 4, 4)."""
    world = []
    for j in range(tree.n_links):
        if tree.types[j] == FIXED:
            local = tree.origins[j].expand(*q.shape[:-1], 4, 4)
        else:
            local = tree.origins[j] @ _joint_motion(tree, j, q)
        parent = tree.parents[j]
        world.append(local if parent < 0 else world[parent] @ local)
    return torch.stack(world, dim=-3)


def link_positions(tree: KinematicTree, q: torch.Tensor) -> torch.Tensor:
    """(..., DOF) -> (..., J, 3) world positions of the link frames."""
    return fk(tree, q)[..., :3, 3]


def _sphere_centers(tree: KinematicTree, world: torch.Tensor) -> torch.Tensor:
    T = world[..., tree.coll_link, :, :]                       # (..., S, 4, 4)
    return torch.einsum("...sij,sj->...si", T[..., :3, :3], tree.coll_offset) + T[..., :3, 3]


def fk_collision_spheres(tree: KinematicTree, q: torch.Tensor) -> torch.Tensor:
    """(..., DOF) -> (..., S, 3) world centers of the collision spheres
    (fk_map_collision, robot_base.py:175-192)."""
    return _sphere_centers(tree, fk(tree, q))


def point_jacobians(tree: KinematicTree, world: torch.Tensor, on_chain: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """d points / d q: world (..., J, 4, 4) from `fk`, points (..., n, 3),
    point i rigidly attached to a link whose row of `tree.on_chain` is
    on_chain[i] (n, J) -> (..., n, 3, DOF)."""
    cols = [torch.zeros_like(points) for _ in range(tree.n_dof)]
    for j in range(tree.n_links):
        if tree.types[j] == FIXED:
            continue
        axis_w = world[..., j, :3, :3] @ tree.axes[j]           # (..., 3)
        if tree.types[j] == REVOLUTE:
            col = torch.linalg.cross(axis_w[..., None, :].expand_as(points),
                                     points - world[..., j, None, :3, 3])
        else:
            col = axis_w[..., None, :].expand_as(points)
        cols[tree.dof_index[j]] = col * on_chain[:, j, None]
    return torch.stack(cols, dim=-1)


def position_jacobian(tree: KinematicTree, q: torch.Tensor, link: int) -> torch.Tensor:
    """The (..., 3, DOF) Jacobian of one link's position
    (compute_analytical_jacobian_all_links, robot_tree.py:250-266)."""
    world = fk(tree, q)
    return point_jacobians(tree, world, tree.on_chain[link:link + 1],
                           world[..., link, None, :3, 3])[..., 0, :, :]


def ik_position(tree: KinematicTree, target_pos: torch.Tensor, q0: torch.Tensor,
                link: Optional[int] = None, n_iters: int = 50,
                damping: float = 1e-2, step: float = 1.0) -> torch.Tensor:
    """Damped-least-squares position IK, n_iters fixed iterations, batched
    over targets (..., 3) and starts (..., DOF) (reference
    inverse_kinematics, robot_tree.py:303-443, loops until it converges;
    JAX and this run a fixed count)."""
    lnk = tree.n_links - 1 if link is None else link
    eye = torch.eye(3, dtype=q0.dtype, device=q0.device)
    q = q0
    for _ in range(n_iters):
        world = fk(tree, q)
        pos = world[..., lnk, :3, 3]
        err = target_pos - pos
        J = point_jacobians(tree, world, tree.on_chain[lnk:lnk + 1],
                            pos[..., None, :])[..., 0, :, :]
        sol, _ = torch.linalg.solve_ex(J @ J.mT + damping * eye, err[..., None])
        dq = (J.mT @ sol)[..., 0]
        q = torch.minimum(torch.maximum(q + step * dq, tree.q_min), tree.q_max)
    return q


# ------------------------------------------------------------ constructors
def make_chain(origins: np.ndarray, axes: np.ndarray, types: Sequence[int],
               q_min: np.ndarray, q_max: np.ndarray,
               coll_spheres: Optional[Sequence[Tuple[int, Sequence[float], float]]] = None,
               device="cuda") -> KinematicTree:
    """A serial chain (link j's parent is j - 1) on `device`."""
    dof_index, d = [], 0
    for t in types:
        dof_index.append(-1 if t == FIXED else d)
        d += t != FIXED
    spheres = coll_spheres or []
    parents = tuple(range(-1, len(types) - 1))
    on_chain = np.zeros((len(types), len(types)), np.float32)
    for link in range(len(types)):
        j = link
        while j >= 0:
            on_chain[link, j] = 1.0
            j = parents[j]
    f32 = dict(dtype=torch.float32, device=device)
    return KinematicTree(
        origins=torch.as_tensor(np.asarray(origins, np.float32), **f32),
        axes=torch.as_tensor(np.asarray(axes, np.float32), **f32),
        q_min=torch.as_tensor(np.asarray(q_min, np.float32), **f32),
        q_max=torch.as_tensor(np.asarray(q_max, np.float32), **f32),
        coll_link=torch.as_tensor([s[0] for s in spheres], dtype=torch.int64,
                                  device=device).reshape(-1),
        coll_offset=torch.as_tensor(np.asarray([s[1] for s in spheres], np.float32),
                                    **f32).reshape(-1, 3),
        coll_radius=torch.as_tensor(np.asarray([s[2] for s in spheres], np.float32),
                                    **f32).reshape(-1),
        on_chain=torch.as_tensor(on_chain, **f32),
        parents=parents,
        types=tuple(types),
        dof_index=tuple(dof_index),
    )


def _mdh_origin(a: float, alpha: float, d: float) -> np.ndarray:
    """Modified-DH constant part: RotX(alpha) @ TransX(a) @ TransZ(d) (the
    theta rotation is the joint's motion about z)."""
    ca, sa = np.cos(alpha), np.sin(alpha)
    T = np.eye(4)
    T[:3, :3] = [[1, 0, 0], [0, ca, -sa], [0, sa, ca]]
    T[:3, 3] = [a, -d * sa, d * ca]
    return T


# Franka Panda modified-DH table (public, Franka Control Interface docs):
# (a_{i-1}, alpha_{i-1}, d_i) per joint + fixed flange (0, 0, 0.107).
PANDA_MDH = [
    (0.0, 0.0, 0.333),
    (0.0, -np.pi / 2, 0.0),
    (0.0, np.pi / 2, 0.316),
    (0.0825, np.pi / 2, 0.0),
    (-0.0825, -np.pi / 2, 0.384),
    (0.0, np.pi / 2, 0.0),
    (0.088, np.pi / 2, 0.0),
]
_PANDA_Q_MIN = [-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973]
_PANDA_Q_MAX = [2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973]


def make_panda(device="cuda") -> KinematicTree:
    """7-DOF Franka Panda arm + fixed flange (the reference's demo robot,
    DifferentiableFrankaPanda, models/robots.py:56-69), from the public
    modified-DH table; one 0.06 sphere at each joint frame and the flange."""
    origins = np.stack([_mdh_origin(*row) for row in PANDA_MDH]
                       + [_mdh_origin(0.0, 0.0, 0.107)])
    axes = np.tile([0.0, 0.0, 1.0], (8, 1))
    types = [REVOLUTE] * 7 + [FIXED]
    spheres = [(j, (0.0, 0.0, 0.0), 0.06) for j in range(8)]
    return make_chain(origins, axes, types, _PANDA_Q_MIN, _PANDA_Q_MAX, spheres, device)


def make_planar_arm(n_links: int = 3, link_length: float = 0.3,
                    n_spheres_per_link: int = 3, sphere_radius: float = 0.04,
                    base_xy: Tuple[float, float] = (0.0, 0.0),
                    device="cuda") -> KinematicTree:
    """Planar arm of n revolute joints about +z in the 2D disk world (base
    at base_xy, links along +x at q = 0), n_spheres_per_link spheres evenly
    along each link, the last at its tip. The sphere centers' xy rows go
    straight into the scene's SDF (the reference's 2D pipeline has only the
    disk robot)."""
    origins = np.stack([_mdh_origin(0.0 if j == 0 else link_length, 0.0, 0.0)
                        for j in range(n_links)])
    origins[0][:2, 3] += np.asarray(base_xy, np.float32)
    axes = np.tile([0.0, 0.0, 1.0], (n_links, 1))
    lim = np.full(n_links, np.pi, np.float32)
    spheres = [(j, ((k + 1) * link_length / n_spheres_per_link, 0.0, 0.0), sphere_radius)
               for j in range(n_links) for k in range(n_spheres_per_link)]
    return make_chain(origins, axes, [REVOLUTE] * n_links, -lim, lim, spheres, device)


# ------------------------------------------------------------ the 2D scene
def _clearances_at(tree: KinematicTree, scene, centers: torch.Tensor,
                   margin: float) -> torch.Tensor:
    """Sphere centers (..., S, 2) -> signed clearances (..., S) against the
    scene's object grid and its workspace box; < 0 is penetration."""
    sdf = grid_sdf_pair(scene.grid, scene.extra_grid, centers)[0]
    ws = torch.minimum(centers - scene.ws_min, scene.ws_max - centers).amin(dim=-1)
    return torch.minimum(sdf, ws) - tree.coll_radius - margin


def arm_scene_clearances(tree: KinematicTree, scene, q: torch.Tensor,
                         margin: float = 0.0) -> torch.Tensor:
    """(..., DOF) -> (..., S): every collision sphere's signed clearance at
    q against the 2D scene (object grid + workspace box); < 0 = penetration.
    One lookup."""
    return _clearances_at(tree, scene, fk_collision_spheres(tree, q)[..., :2], margin)


def arm_clearances_and_jacobian(tree: KinematicTree, scene, q: torch.Tensor,
                                margin: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clearances (..., S), d clearances / d q (..., S, DOF)) at q (..., DOF),
    from one lookup: the derivative in each sphere's center by autograd
    (the floor cell's gradient; `torch.minimum` and `amin` split a tie as
    JAX's do), times the sphere's Jacobian."""
    world = fk(tree, q)
    centers = _sphere_centers(tree, world)
    with torch.enable_grad():
        c = centers[..., :2].detach().requires_grad_(True)
        clear = _clearances_at(tree, scene, c, margin)
        (d_center,) = torch.autograd.grad(clear.sum(), c)
    J = point_jacobians(tree, world, tree.on_chain[tree.coll_link], centers)[..., :2, :]
    return clear.detach(), (d_center[..., None] * J).sum(dim=-2)


def arm_scene_collision(tree: KinematicTree, scene, q: torch.Tensor,
                        margin: float = 0.0) -> torch.Tensor:
    """(..., DOF) -> (...,) bool: any collision sphere of the arm at q
    penetrates the 2D scene."""
    return torch.any(arm_scene_clearances(tree, scene, q, margin) < 0.0, dim=-1)


def via_point_seeds(q_start: torch.Tensor, q_goal: torch.Tensor, vias: torch.Tensor,
                    horizon: int) -> torch.Tensor:
    """Piecewise-linear start -> via -> goal seeds, vias (P, DOF) ->
    (P, H, 2 DOF) [q, dq/dstep] (the reference's 'random' init,
    mp_baselines base.py:141-203)."""
    h2 = horizon // 2
    a = to_device(linspace_f32(0.0, 1.0, h2), q_start.device, q_start.dtype)[:, None]
    b = to_device(linspace_f32(0.0, 1.0, horizon - h2), q_start.device, q_start.dtype)[:, None]
    via = vias[:, None, :]
    first = (1 - a) * q_start + a * via
    second = (1 - b) * via + b * q_goal
    qs = torch.cat([first, second], dim=1)
    # jnp.gradient's arithmetic: one-sided at the ends, halved inside.
    return torch.cat([qs, torch.gradient(qs, dim=1)[0]], dim=-1)


def plan_arm_gpmp2(tree: KinematicTree, scene, q_start: torch.Tensor, q_goal: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   vias: Optional[torch.Tensor] = None, n_particles: int = 16,
                   horizon: int = 64, opt_iters: int = 400, margin: float = 0.01,
                   sigma_coll: float = 5e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """An arm's motion in a 2D scene by GPMP2 over joint space, its
    collision factor the FK spheres' clearances. Returns (trajs (P, H,
    2 DOF), free (P,) bool: every sphere clear at every waypoint).

    Each particle starts from a via-point seed, its via uniform in the joint
    box (from `generator`, or `vias` (P, DOF) as given), particle 0's the
    midpoint of start and goal: GPMP2 is local, so diverse homotopy classes
    must come from the seeds. One lookup an iteration and one for `free`;
    nothing is read to the host."""
    from mmd_torch.datagen.gpmp2 import GPMP2Config, gpmp2_optimize

    D = tree.n_dof
    cfg = GPMP2Config(n_support_points=horizon, opt_iters=opt_iters, sigma_coll=sigma_coll,
                      step_size=0.15)
    if vias is None:
        if generator is None:
            raise ValueError("plan_arm_gpmp2 needs a generator or the vias")
        u = torch.rand((n_particles, D), generator=generator, dtype=q_start.dtype,
                       device=q_start.device)
        vias = tree.q_min + u * (tree.q_max - tree.q_min)
    vias = vias.clone()
    vias[0] = 0.5 * (q_start + q_goal)  # keep one direct seed
    inits = via_point_seeds(q_start, q_goal, vias, horizon)

    def coll_fn(states):  # (P, H-1, 2 DOF) -> clearances (P, H-1, S) and d / d q
        return arm_clearances_and_jacobian(tree, scene, states[..., :D], margin)

    zeros = torch.zeros_like(q_start)
    trajs = gpmp2_optimize(scene, torch.cat([q_start, zeros]), torch.cat([q_goal, zeros]),
                           inits, cfg, coll_fn=coll_fn)
    free = (arm_scene_clearances(tree, scene, trajs[..., :D]) >= 0.0).flatten(1).all(dim=1)
    return trajs, free
