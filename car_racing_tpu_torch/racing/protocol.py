"""The LMPC learning protocol from a standing start
(car_racing_tpu/racing/protocol.py).

A PID seed lap, an MPC-LTI seed lap, then ``n_laps`` of LMPC learning:

  rollout_pid  ->  fused.rollout_mpc_tracking  ->  fused.rollout_lmpc_learning

Each stage is one closed-loop rollout on the track's device; between stages
the host cuts the first completed lap out of the trajectory and builds its
safe-set column in numpy, with the host ``add_trajectory`` semantics of the
JAX package (``cut_first_lap``, ``lap_column_from_traj``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import controllers
from ..ops import dynamics, track as track_ops
from ..utils.constants import U_DIM, X_DIM
from ..utils.params import LMPCParam, MPCParam, SystemParam
from . import fused

SENTINEL = 1e4


def rollout_pid_batch(
    track,
    bike_params,
    xtarget,
    xcurv0_batch,
    xglob0_batch,
    n_steps: int = 400,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop PID tracking of ``xtarget`` by a fleet of ``B`` vehicles:
    each control step the PID input, then one control period through K1.
    Returns (xcurv (B, n_steps+1, 6), u (B, n_steps, 2))."""
    xcurv, xglob = xcurv0_batch, xglob0_batch
    xcurvs, us = [xcurv], []
    for _ in range(n_steps):
        u = controllers.pid(xcurv, xtarget).contiguous()
        xglob, xcurv = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt, sub_dt=sub_dt)
        xcurvs.append(xcurv)
        us.append(u)
    return torch.stack(xcurvs, dim=1), torch.stack(us, dim=1)


def rollout_pid(
    track,
    bike_params,
    xtarget,
    xcurv0,
    xglob0,
    n_steps: int = 400,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop PID tracking of one vehicle from ``xcurv0 (6,)``.
    Returns (xcurv (n_steps+1, 6), u (n_steps, 2))."""
    xc, us = rollout_pid_batch(track, bike_params, xtarget, xcurv0[None], xglob0[None],
                               n_steps=n_steps, control_dt=control_dt, sub_dt=sub_dt)
    return xc[0], us[0]


def cut_first_lap(xc, us, lap_length: float):
    """Cut the first completed lap out of a rollout trajectory.

    Returns (lap_xc (T+1, 6) with the crossing row un-wrapped, lap_u (T, 2),
    T, the crossing state with s wrapped), numpy; the wrapped state seeds
    the next stage."""
    xc = np.asarray(xc)
    us = np.asarray(us)
    crossed = np.nonzero(xc[:, 4] >= lap_length)[0]
    if len(crossed) == 0:
        raise RuntimeError("rollout never completed a lap; raise n_steps")
    T = int(crossed[0])  # the first row with s >= L: the lap's step count
    x_wrapped = np.array(xc[T], copy=True)
    x_wrapped[4] -= lap_length
    return xc[: T + 1], us[:T], T, x_wrapped


def lap_column_from_traj(lap_xc, lap_u, P: int):
    """A safe-set column from a cut lap, host ``add_trajectory`` semantics:
    rows 0..T-1 the lap's states, row T the crossing state with s
    un-wrapped, inputs in rows 0..T-1, sentinels beyond, and Qfun ``(T-1) -
    arange(P)`` everywhere (the crossing row's -1 included).
    Returns (ss (P, 6), u (P, 2), qfun (P,)), numpy."""
    T = len(lap_xc) - 1
    ss = np.full((P, X_DIM), SENTINEL)
    uu = np.full((P, U_DIM), SENTINEL)
    ss[: T + 1] = lap_xc
    uu[:T] = lap_u
    q = (T - 1) - np.arange(P, dtype=float)
    return ss, uu, q


def run_learning_protocol(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams | None = None,
    lmpc_param: LMPCParam | None = None,
    mpc_param: MPCParam | None = None,
    sys_param: SystemParam | None = None,
    n_laps: int = 3,
    seed_vt: float = 0.7,
    P: int | None = None,
    n_steps_seed: int | None = None,
    n_steps_learn: int | None = None,
):
    """Zero state -> PID lap -> MPC-LTI lap -> ``n_laps`` of LMPC learning,
    on the track's device and in its dtype.

    ``P`` (safe-set column rows), ``n_steps_seed`` and ``n_steps_learn``
    size themselves from the lap length and the seed laps when omitted.

    Returns a dict: ``lap_steps`` (the learning curve, [PID, MPC, lmpc_1..n]),
    the learning rollout's ``xcurv`` and ``u``, and the seed laps' columns
    ``seed_columns`` ({ss0, q0, ss1, q1}), all numpy."""
    kw = dict(device=track.lap_length.device, dtype=track.lap_length.dtype)
    bike_params = bike_params or dynamics.BicycleParams.default(**kw)
    lmpc_param = lmpc_param or LMPCParam.default(**kw)
    mpc_param = mpc_param or MPCParam.default(vt=seed_vt, **kw)
    sys_param = sys_param or SystemParam.default(**kw)
    L = float(track.lap_length)
    N = lmpc_param.num_horizon
    xtarget = controllers.target_state(seed_vt, 0.0, **kw)
    t = lambda a: torch.as_tensor(np.asarray(a), **kw)
    # 1.8x the steady-state lap at seed_vt covers the standing-start ramp
    # (an explicit 0 must fail downstream, not fall back to the default)
    if n_steps_seed is None:
        n_steps_seed = int(L / seed_vt / 0.1 * 1.8)

    # stage 1: the PID seed lap
    zeros = torch.zeros(X_DIM, **kw)
    xc, us = rollout_pid(track, bike_params, xtarget, zeros, zeros, n_steps=n_steps_seed)
    lap_xc0, lap_u0, t0, x_w = cut_first_lap(xc.cpu().numpy(), us.cpu().numpy(), L)

    # stage 2: the MPC-LTI seed lap, from where the PID lap crossed the line
    xg_w = track_ops.frenet_to_global_state(track, t(x_w))
    xc, us = fused.rollout_mpc_tracking(track, bike_params, mpc_param, sys_param, xtarget,
                                        t(x_w), xg_w, n_steps=n_steps_seed)
    lap_xc1, lap_u1, t1, x_w = cut_first_lap(xc.cpu().numpy(), us.cpu().numpy(), L)

    # lap iter-1's column also holds the next lap's add_point appendix
    # (rows t1+1 .. t1+T_next, T_next <= t1)
    if P is None:
        P = 2 * max(t0, t1) + N + 3
    # the learning rollout clips its row indices to P-1: an undersized
    # column would overwrite its last row and corrupt the learned safe set
    assert P >= t1 + max(t0, t1) + 2, (
        f"safe-set column capacity P={P} cannot hold the appendix of a lap "
        f"up to {max(t0, t1)} steps after the {t1}-step seed lap "
        "(need P >= t_prev + lap_steps + 1)"
    )
    ss0, u0, q0 = lap_column_from_traj(lap_xc0, lap_u0, P)
    ss1, u1, q1 = lap_column_from_traj(lap_xc1, lap_u1, P)
    if n_steps_learn is None:
        n_steps_learn = n_laps * t1 + 10

    # stage 3: the learning rollout; its first linearization is host
    # add_trajectory's iter == 0 branch
    xg_w = track_ops.frenet_to_global_state(track, t(x_w))
    xc, us, lap_steps, laps_done = fused.rollout_lmpc_learning(
        track, bike_params, lmpc_param, sys_param, t(x_w), xg_w,
        t(ss1), t(q1), t(u1), t1, t(ss0), t(q0), t(u0), t0,
        t(ss0[1: N + 2]), t(u0[1: N + 1]), n_laps=n_laps, n_steps=n_steps_learn,
    )
    if int(laps_done) < n_laps:
        raise RuntimeError(
            f"learning rollout finished only {int(laps_done)}/{n_laps} laps; "
            "raise n_steps_learn"
        )
    return {
        "lap_steps": [t0, t1] + [int(v) for v in lap_steps.tolist()],
        "xcurv": xc.cpu().numpy(),
        "u": us.cpu().numpy(),
        "seed_columns": {"ss0": ss0, "q0": q0, "ss1": ss1, "q1": q1},
    }


def export_learned_raceline(out: dict, track, layout: str, data_dir: str = "data"):
    """Write the fastest learned lap of a :func:`run_learning_protocol`
    result as ``{data_dir}/optimal_traj/x{curv,glob}_{layout}_learned.csv``,
    the reference's save-trajectory format.

    Returns the protocol-wide iteration index of the exported lap."""
    learned = out["lap_steps"][2:]
    best = int(np.argmin(learned))
    off = int(np.sum(learned[:best], dtype=int))
    T = learned[best]
    L = float(track.lap_length)
    # the lap's rows with s wrapped, and its crossing row un-wrapped
    lap = np.array(out["xcurv"][off: off + T + 1], copy=True)
    lap[T, 4] += L
    kw = dict(device=track.lap_length.device, dtype=track.lap_length.dtype)
    xg = track_ops.frenet_to_global_state(track, torch.as_tensor(lap, **kw)).cpu().numpy()
    os.makedirs(f"{data_dir}/optimal_traj", exist_ok=True)
    np.savetxt(f"{data_dir}/optimal_traj/xcurv_{layout}_learned.csv", lap, delimiter=",")
    np.savetxt(f"{data_dir}/optimal_traj/xglob_{layout}_learned.csv", xg, delimiter=",")
    return 2 + best
