"""Closed-loop rollouts (car_racing_tpu/racing/fused.py:31-75, 1032-1042).

The JAX package fuses the receding-horizon loop into one ``lax.scan`` and
``vmap``s it over a fleet.  Here the loop is a Python loop over control
steps, and the fleet is the batch dimension of every call inside it: one
MPC-LTI solve for all lanes, then one launch of the integrator kernel K1.
"""

from __future__ import annotations

import torch

from ..models import controllers
from ..ops import dynamics
from ..utils.constants import U_DIM


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
