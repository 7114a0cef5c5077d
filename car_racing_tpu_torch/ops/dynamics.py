"""Dynamic bicycle model with Pacejka tire forces
(car_racing_tpu/ops/dynamics.py:29-262).

Every function takes a leading batch of vehicles: ``xglob``, ``xcurv`` are
``(B, 6)`` and ``u`` is ``(B, 2)``.  The expressions keep the JAX package's
order of operations, so the plain loop agrees with its ``lax.scan`` to
rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve
from . import track as track_ops


@dataclasses.dataclass(frozen=True)
class BicycleParams:
    """Bicycle + Pacejka tire parameters (0-d tensors)."""

    m: torch.Tensor
    lf: torch.Tensor
    lr: torch.Tensor
    Iz: torch.Tensor
    Df: torch.Tensor
    Cf: torch.Tensor
    Bf: torch.Tensor
    Dr: torch.Tensor
    Cr: torch.Tensor
    Br: torch.Tensor

    @staticmethod
    def default(*, device="cuda", dtype=torch.float64) -> "BicycleParams":
        dev = resolve(device)
        f = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        return BicycleParams(
            m=f(1.98),
            lf=f(0.125),
            lr=f(0.125),
            Iz=f(0.024),
            Df=f(0.8 * 1.98 * 9.81 / 2.0),
            Cf=f(1.25),
            Bf=f(1.0),
            Dr=f(0.8 * 1.98 * 9.81 / 2.0),
            Cr=f(1.25),
            Br=f(1.0),
        )


def tire_forces(params: BicycleParams, xcurv: torch.Tensor, delta: torch.Tensor):
    """Front/rear lateral tire forces; the rear slip angle uses ``lr``."""
    vx, vy, wz = xcurv[..., 0], xcurv[..., 1], xcurv[..., 2]
    alpha_f = delta - torch.atan2(vy + params.lf * wz, vx)
    alpha_r = -torch.atan2(vy - params.lr * wz, vx)
    Fyf = 2 * params.Df * torch.sin(params.Cf * torch.atan(params.Bf * alpha_f))
    Fyr = 2 * params.Dr * torch.sin(params.Cr * torch.atan(params.Br * alpha_r))
    return Fyf, Fyr


def step(params: BicycleParams, curv, xglob, xcurv, dt, u):
    """One explicit-Euler step of (xglob, xcurv).

    The velocity rows of ``xglob_next`` are those of ``xcurv_next``: the
    input ``xglob``'s ``vx, vy, wz`` are never read."""
    delta, a = u[..., 0], u[..., 1]
    vx, vy, wz = xcurv[..., 0], xcurv[..., 1], xcurv[..., 2]
    epsi, s, ey = xcurv[..., 3], xcurv[..., 4], xcurv[..., 5]
    psi = xglob[..., 3]

    Fyf, Fyr = tire_forces(params, xcurv, delta)
    dvx = a - Fyf * torch.sin(delta) / params.m + wz * vy
    dvy = (Fyf * torch.cos(delta) + Fyr) / params.m - wz * vx
    dwz = (params.lf * Fyf * torch.cos(delta) - params.lr * Fyr) / params.Iz

    den = 1.0 - curv * ey
    s_dot = (vx * torch.cos(epsi) - vy * torch.sin(epsi)) / den
    vx_n = vx + dt * dvx
    vy_n = vy + dt * dvy
    wz_n = wz + dt * dwz
    xcurv_next = torch.stack(
        [
            vx_n,
            vy_n,
            wz_n,
            epsi + dt * (wz - s_dot * curv),
            s + dt * s_dot,
            ey + dt * (vx * torch.sin(epsi) + vy * torch.cos(epsi)),
        ],
        dim=-1,
    )
    xglob_next = torch.stack(
        [
            vx_n,
            vy_n,
            wz_n,
            psi + dt * wz,
            xglob[..., 4] + dt * (vx * torch.cos(psi) - vy * torch.sin(psi)),
            xglob[..., 5] + dt * (vx * torch.sin(psi) + vy * torch.cos(psi)),
        ],
        dim=-1,
    )
    return xglob_next, xcurv_next


def curv_step(track: track_ops.Track, params: BicycleParams, xcurv, u, dt):
    """Curvilinear-only Euler step with the on-track curvature lookup."""
    curv = track_ops.curvature(track, xcurv[..., 4])
    _, xcurv_next = step(params, curv, torch.zeros_like(xcurv), xcurv, dt, u)
    return xcurv_next


def propagate(
    track: track_ops.Track,
    params: BicycleParams,
    xglob: torch.Tensor,
    xcurv: torch.Tensor,
    u: torch.Tensor,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    backend: str = "auto",
):
    """Propagate a ``(B, 6)`` batch over one control period of
    ``round(control_dt / sub_dt)`` Euler substeps, looking the curvature up
    again at every substep.  Returns ``(xglob_next, xcurv_next)``.

    ``backend``: ``"auto"`` runs the CUDA kernel for CUDA tensors and the
    plain loop for CPU tensors; ``"plain"`` forces the plain loop (the
    kernel's reference); ``"cuda"`` requires CUDA tensors.
    """
    from ..kernels import propagate as k1  # which imports this module

    if backend == "plain":
        return k1.plain(track, params, xglob, xcurv, u, control_dt, sub_dt)
    if backend == "cuda" and xcurv.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {xcurv.device}")
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return k1.propagate(track, params, xglob, xcurv, u, control_dt, sub_dt)


NOISE_SCALE = (0.01, 0.01, 0.005)  # (vx, vy, wz) standard deviations
NOISE_CLIP = (0.05, 0.1, 0.05)


def process_noise(generator: torch.Generator, xcurv: torch.Tensor) -> torch.Tensor:
    """Truncated-Gaussian process noise on (vx, vy, wz) of a ``(B, 6)``
    batch (dynamics.py:199-211): ``0.5 * clip(N(0, 1) * scale, -clip,
    clip)`` added to the first three states.  ``generator`` (on
    ``xcurv``'s device) draws the normals; ``jax.random``'s stream cannot
    be reproduced, so only the distribution matches the JAX package's."""
    z = torch.randn(xcurv.shape[:-1] + (3,), generator=generator, dtype=xcurv.dtype,
                    device=xcurv.device)
    scale = z.new_tensor(NOISE_SCALE)
    clip = z.new_tensor(NOISE_CLIP)
    noise = torch.clamp(z * scale, -clip, clip)
    return torch.cat([xcurv[..., :3] + 0.5 * noise, xcurv[..., 3:]], dim=-1)


def const_velocity_prediction(track: track_ops.Track, xcurv, xglob, dt, n_steps: int):
    """``n_steps``-step constant-velocity prediction of ``(..., 6)`` states
    (dynamics.py:225-262): velocities frozen, the Frenet and global
    kinematics integrated at the control period, s wrapped onto the lap.
    Returns (xcurv_traj, xglob_traj), each ``(..., n_steps, 6)``, row 0
    the given state."""
    xcs, xgs = [], []
    xc, xg = xcurv, xglob
    for _ in range(n_steps):
        xcs.append(xc)
        xgs.append(xg)
        vx, vy, wz, epsi, s, ey = xc.unbind(-1)
        curv = track_ops.curvature(track, s)
        den = 1.0 - curv * ey
        s_dot = (vx * torch.cos(epsi) - vy * torch.sin(epsi)) / den
        xc = torch.stack([
            vx,
            vy,
            wz,
            epsi + dt * (wz - s_dot * curv),
            torch.remainder(s + dt * s_dot, track.lap_length),
            ey + dt * (vx * torch.sin(epsi) + vy * torch.cos(epsi)),
        ], dim=-1)
        gvx, gvy, gwz, psi, X, Y = xg.unbind(-1)
        xg = torch.stack([
            gvx,
            gvy,
            gwz,
            psi + dt * gwz,
            X + dt * (gvx * torch.cos(psi) - gvy * torch.sin(psi)),
            Y + dt * (gvx * torch.sin(psi) + gvy * torch.cos(psi)),
        ], dim=-1)
    return torch.stack(xcs, dim=-2), torch.stack(xgs, dim=-2)
