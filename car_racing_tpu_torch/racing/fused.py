"""Closed-loop rollouts (car_racing_tpu/racing/fused.py:31-75, 261-411,
1032-1042).

The JAX package fuses the receding-horizon loop into one ``lax.scan`` and
``vmap``s it over a fleet.  Here the loop is a Python loop over control
steps, and the fleet is the batch dimension of every call inside it: one
MPC-LTI solve for all lanes, then one launch of the integrator kernel K1.
"""

from __future__ import annotations

import torch

from ..models import controllers
from ..ops import dynamics, lmpc_learning, track as track_ops
from ..utils.constants import U_DIM, X_DIM


def rollout_mpc_tracking_batch(
    track,
    bike_params,
    mpc_param,
    sys_param,
    xtarget,
    xcurv0_batch,
    xglob0_batch,
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop MPC-LTI tracking of a fleet of ``B`` vehicles.

    Each control step: the condensed QP of every lane, warm-started by its
    shifted previous solution, then one control period of Euler substeps.
    Returns (xcurv_traj (B, n_steps+1, 6), u_traj (B, n_steps, 2)).
    """
    N = mpc_param.num_horizon
    xcurv, xglob = xcurv0_batch, xglob0_batch
    width = track.width.to(xcurv.dtype)
    u_warm = xcurv.new_zeros(xcurv.shape[0], N * U_DIM)
    xcurvs, us = [xcurv], []
    for _ in range(n_steps):
        u0, U, _ = controllers.mpc_lti(
            xcurv, xtarget, mpc_param, sys_param, width, u_warm=u_warm, return_traj=True
        )
        u0 = u0.contiguous()
        xglob, xcurv = dynamics.propagate(
            track, bike_params, xglob, xcurv, u0, control_dt=control_dt, sub_dt=sub_dt
        )
        flat = U.reshape(U.shape[0], -1)
        u_warm = torch.cat([flat[:, U_DIM:], flat[:, -U_DIM:]], dim=1)
        xcurvs.append(xcurv)
        us.append(u0)
    return torch.stack(xcurvs, dim=1), torch.stack(us, dim=1)


def rollout_mpc_tracking(
    track,
    bike_params,
    mpc_param,
    sys_param,
    xtarget,
    xcurv0,
    xglob0,
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop MPC-LTI tracking of one vehicle from ``xcurv0 (6,)``.
    Returns (xcurv_traj (n_steps+1, 6), u_traj (n_steps, 2))."""
    xc, us = rollout_mpc_tracking_batch(
        track, bike_params, mpc_param, sys_param, xtarget, xcurv0[None], xglob0[None],
        n_steps=n_steps, control_dt=control_dt, sub_dt=sub_dt,
    )
    return xc[0], us[0]


def rollout_lmpc_lap(
    track,
    bike_params,
    lmpc_param,
    sys_param,
    xcurv0,
    xglob0,
    ss_prev,
    qfun_prev,
    ss_prev2,
    qfun_prev2,
    u_prev_lap,
    u_prev2_lap,
    valid_prev,
    valid_prev2,
    counter: int,
    lin_points0,
    lin_input0,
    n_steps: int = 400,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    solves: list | None = None,
):
    """One LMPC learning lap of one vehicle from ``xcurv0 (6,)``.

    ``ss_prev``/``ss_prev2`` (P, 6) are the safe sets of the last two laps
    (sentinel-padded), ``qfun_*`` (P,) their cost-to-go, ``u_*_lap`` (P, 2)
    their inputs and ``valid_*`` (P,) their regression-row masks;
    ``counter`` is lap iter-1's length (the append offset), ``lin_points0
    (N+1, 6)`` and ``lin_input0 (N, 2)`` the first linearization.

    Every step: the local regression over the horizon, the safe-set
    selection from both laps, the LMPC QP (dense LU interior point), one
    control period through K1, and the reference's ``add_point``: the
    state, with s one lap on, is written into lap iter-1's safe set at
    ``clip(counter + k + 1, 0, P - 1)``.  That write goes into a copy of
    ``ss_prev``, in place; the caller's tensor is not changed.  Once s
    passes the lap length (``done``) the carry freezes, as the JAX scan's
    does, and the loop still runs all ``n_steps``.  If ``solves`` is a
    list, each step's LMPC solution (``ipm.IPMSolution``, batch of one) is
    appended to it.

    Returns (xcurv (n_steps+1, 6), u (n_steps, 2), done (n_steps,) bool,
    lap_steps (int))."""
    N = lmpc_param.num_horizon
    K_per = lmpc_param.num_ss_points // lmpc_param.num_ss_iter
    dtype = xcurv0.dtype
    L = track.lap_length.to(dtype)
    W = track.width.to(dtype)
    P = ss_prev.shape[0]
    n_u = N * U_DIM
    dt = torch.tensor(control_dt, dtype=dtype, device=xcurv0.device)

    u_data = torch.stack([u_prev2_lap, u_prev_lap])
    valid = torch.stack([valid_prev2, valid_prev])
    lap_shift = xcurv0.new_zeros(X_DIM)
    lap_shift[4] = L

    xcurv, xglob = xcurv0, xglob0
    ss1 = ss_prev.clone()
    lin_points, lin_input = lin_points0, lin_input0
    u_prev = xcurv0.new_zeros(U_DIM)
    z_warm = None  # lmpc_qp's default: zero inputs, lambda = 1/K
    done = False
    xcurvs, us, dones = [], [], []
    for k in range(n_steps):
        x = xcurv.clone()
        x[4] = torch.remainder(xcurv[4], L)
        curvs = track_ops.curvature(track, torch.remainder(lin_points[:N, 4], L))
        A_tv, B_tv, C_tv = lmpc_learning.estimate_abc_horizon(
            lin_points[:N], lin_input[:N], torch.stack([ss_prev2, ss1]), u_data, valid, curvs, dt)
        pts1, q1 = lmpc_learning.select_points(ss1, qfun_prev, x, K_per, lmpc_param.shift)
        pts2, q2 = lmpc_learning.select_points(ss_prev2, qfun_prev2, x, K_per, lmpc_param.shift)
        U, X, sol = controllers.lmpc(
            x[None], lmpc_param, A_tv, B_tv, C_tv, torch.cat([pts1, pts2], dim=1)[None],
            torch.cat([q1, q2])[None], u_prev[None], sys_param, W, z_warm=z_warm)
        if solves is not None:
            solves.append(sol)
        U, X = U[0], X[0]
        u = U[0]
        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob[None], xcurv[None], u[None].contiguous(),
            control_dt=control_dt, sub_dt=sub_dt)
        xcurvs.append(xcurv)
        us.append(u)
        dones.append(done)
        if done:  # the carry stays frozen
            continue
        ss1[min(max(counter + k + 1, 0), P - 1)] = x + lap_shift  # add_point
        xcurv, xglob = xcurv_next[0], xglob_next[0]
        lin_points = torch.cat([X[1:], X[-1:]])
        lin_input = torch.cat([U[1:], U[-1:]])
        u_prev = u
        z_warm = torch.cat([U[1:].reshape(-1), U[-1], sol.z[0, n_u:]])[None]
        done = bool(xcurv[4] >= L)
    xcurvs.append(xcurv)
    dones = torch.tensor(dones, device=xcurv0.device)
    return torch.stack(xcurvs), torch.stack(us), dones, int((~dones).sum())
