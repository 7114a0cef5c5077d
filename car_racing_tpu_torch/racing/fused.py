"""Closed-loop rollouts (car_racing_tpu/racing/fused.py:31-258, 261-604,
1003-1042).

The JAX package fuses the receding-horizon loop into one ``lax.scan`` and
``vmap``s it over a fleet.  Here the loop is a Python loop over control
steps, and the fleet is the batch dimension of every call inside it: one
MPC-LTI or LMPC solve for all lanes, then one launch of the integrator
kernel K1.  The obstacle-avoidance rollouts (MPC-CBF, iLQR) drive one
vehicle, as the JAX ones do.
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


def promote(lap_ss, lap_u, T, xcurv_cross):
    """The safe-set column of the lap just driven, with host
    ``add_trajectory`` semantics (fused.py:493-504): rows ``0..T-1`` the
    lap's states and inputs from the clean per-lap buffer ``lap_ss (..., P,
    6)``, ``lap_u (..., P, 2)``, row ``T`` (clipped into the column) the
    crossing state ``xcurv_cross (..., 6)`` with s un-wrapped, sentinels
    beyond, and Qfun ``(T-1) - arange(P)``.

    The buffer, not the ``add_point`` appendix, is the source: the appendix
    holds ``x + L``, and un-shifting it re-rounds s by an ulp, which the JAX
    package measured as 1e-5 m of drift over three laps.  T (...) int.
    Returns (ss (..., P, 6), u (..., P, 2), qfun (..., P))."""
    P = lap_ss.shape[-2]
    rows = torch.arange(P, device=lap_ss.device)
    in_lap = (rows < T.unsqueeze(-1)).unsqueeze(-1)
    cross_row = (rows == T.clamp(0, P - 1).unsqueeze(-1)).unsqueeze(-1)
    ss = torch.where(cross_row, xcurv_cross.unsqueeze(-2),
                     torch.where(in_lap, lap_ss, lmpc_learning.SENTINEL))
    u = torch.where(in_lap, lap_u, lmpc_learning.SENTINEL)
    q = (T.unsqueeze(-1) - 1 - rows).to(lap_ss.dtype)
    return ss, u, q


def _lanes(mask, new, old):
    """``new`` where the lane's ``mask (B,)`` is set, else ``old``."""
    return torch.where(mask.view(-1, *[1] * (new.dim() - 1)), new, old)


def rollout_lmpc_learning_batch(
    track,
    bike_params,
    lmpc_param,
    sys_param,
    xcurv0_batch,
    xglob0_batch,
    ss_prev,
    qfun_prev,
    u_prev_lap,
    t_prev: int,
    ss_prev2,
    qfun_prev2,
    u_prev2_lap,
    t_prev2: int,
    lin_points0,
    lin_input0,
    n_laps: int = 3,
    n_steps: int = 600,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    solves: list | None = None,
):
    """Multi-lap LMPC learning of a fleet of ``B`` vehicles from the starts
    ``xcurv0_batch (B, 6)``, ``xglob0_batch (B, 6)`` and shared seed
    columns (fused.py:414-604, 1003-1029).

    ``ss_prev (P, 6)``, ``qfun_prev (P,)``, ``u_prev_lap (P, 2)`` and
    ``t_prev`` are lap iter-1's column and step count, ``*_prev2`` lap
    iter-2's; ``lin_points0 (N+1, 6)`` and ``lin_input0 (N, 2)`` the first
    linearization.  Each lane carries its own copy of both columns, their
    inputs, Qfun and lap lengths, a clean per-lap buffer, its
    linearization, input-rate anchor and warm start, and its step within
    the lap and lap count.

    Every step, for all lanes at once: the local regression over each
    lane's two columns (validity ``rows < t - 1``), the safe-set selection,
    the LMPC QP (one dense-LU interior point for the batch), one control
    period through K1, and ``add_point``: the state, with s one lap on, is
    written into column A at ``clip(tA + k_in_lap + 1, 0, P-1)``, the state
    and input into the per-lap buffer.  At a lane's crossing its lap is
    promoted (:func:`promote`) into column A, the old column A (with its
    appendix) is demoted to column B, and s wraps.  After ``n_laps``
    crossings the lane's carry freezes, but as in the JAX scan its column A
    and buffer still take the step's writes, which the next solves read.

    Every column must hold the appendix of each lap it absorbs: ``P >=
    t_prev + lap_steps + 1`` (``run_learning_protocol`` asserts it).  A
    single lane goes through the shared-linearization calls that
    :func:`rollout_lmpc_lap` makes, so its first lap is that lap's
    arithmetic bit for bit (batched products and LU may round otherwise).
    If ``solves`` is a list, each step's ``ipm.IPMSolution`` is appended.

    Returns (xcurv (B, n_steps+1, 6) with s wrapped per lap, u (B, n_steps,
    2), lap_steps (B, n_laps) int32, laps_done (B,) int32)."""
    N = lmpc_param.num_horizon
    K = lmpc_param.num_ss_points
    K_per = K // lmpc_param.num_ss_iter
    Bn = xcurv0_batch.shape[0]
    dtype, dev = xcurv0_batch.dtype, xcurv0_batch.device
    L = track.lap_length.to(dtype)
    W = track.width.to(dtype)
    P = ss_prev.shape[0]
    n_u = N * U_DIM
    dt = torch.tensor(control_dt, dtype=dtype, device=dev)
    rows = torch.arange(P, device=dev)
    lanes = torch.arange(Bn, device=dev)
    lapshift = xcurv0_batch.new_zeros(X_DIM)
    lapshift[4] = L
    # one lane: drop the lane dimension of what the linearization reads
    shared = (lambda t: t[0]) if Bn == 1 else (lambda t: t)

    per_lane = lambda t: t.expand(Bn, *t.shape).clone()
    ssA, uA, qA = per_lane(ss_prev), per_lane(u_prev_lap), per_lane(qfun_prev)
    ssB, uB, qB = per_lane(ss_prev2), per_lane(u_prev2_lap), per_lane(qfun_prev2)
    tA = torch.full((Bn,), int(t_prev), device=dev)
    tB = torch.full((Bn,), int(t_prev2), device=dev)
    lap_ss = xcurv0_batch.new_full((Bn, P, X_DIM), lmpc_learning.SENTINEL)
    lap_u = xcurv0_batch.new_full((Bn, P, U_DIM), lmpc_learning.SENTINEL)
    lin_points, lin_input = per_lane(lin_points0), per_lane(lin_input0)
    u_prev = xcurv0_batch.new_zeros(Bn, U_DIM)
    z_warm = xcurv0_batch.new_zeros(Bn, n_u + K)  # lmpc_qp's default
    z_warm[:, n_u:] = 1.0 / K
    k_in_lap = torch.zeros(Bn, dtype=torch.long, device=dev)
    lap_idx = torch.zeros(Bn, dtype=torch.long, device=dev)
    xcurv, xglob = xcurv0_batch, xglob0_batch
    xcurvs, us, lap_ids, dones = [], [], [], []
    for _ in range(n_steps):
        done = lap_idx >= n_laps
        x = xcurv.clone()
        x[:, 4] = torch.remainder(xcurv[:, 4], L)
        curvs = track_ops.curvature(track, torch.remainder(lin_points[:, :N, 4], L))
        valid = torch.stack([rows < tB[:, None] - 1, rows < tA[:, None] - 1], dim=1)
        A_tv, B_tv, C_tv = lmpc_learning.estimate_abc_horizon(
            shared(lin_points[:, :N]), shared(lin_input[:, :N]),
            shared(torch.stack([ssB, ssA], dim=1)), shared(torch.stack([uB, uA], dim=1)),
            shared(valid), shared(curvs), dt)
        pts1, q1 = lmpc_learning.select_points(shared(ssA), shared(qA), x, K_per, lmpc_param.shift)
        pts2, q2 = lmpc_learning.select_points(shared(ssB), shared(qB), x, K_per, lmpc_param.shift)
        U, X, sol = controllers.lmpc(
            x, lmpc_param, A_tv, B_tv, C_tv, torch.cat([pts1, pts2], dim=-1),
            torch.cat([q1, q2], dim=-1), u_prev, sys_param, W, z_warm=z_warm)
        if solves is not None:
            solves.append(sol)
        u = U[:, 0].contiguous()
        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt, sub_dt=sub_dt)
        xcurvs.append(xcurv)
        us.append(u)
        lap_ids.append(lap_idx)
        dones.append(done)

        # add_point into column A, and the clean per-lap buffer
        idx = (tA + k_in_lap + 1).clamp(0, P - 1)
        ssA[lanes, idx] = x + lapshift
        uA[lanes, idx] = u
        kidx = k_in_lap.clamp(0, P - 1)
        lap_ss[lanes, kidx] = x
        lap_u[lanes, kidx] = u

        # a crossing promotes the lap into column A and demotes A to B
        crossing = (xcurv_next[:, 4] >= L) & ~done
        T = k_in_lap + 1
        ss_new, u_new, q_new = promote(lap_ss, lap_u, T, xcurv_next)
        sel = lambda new, old: _lanes(crossing, new, old)
        ssB2, uB2, qB2, tB2 = sel(ssA, ssB), sel(uA, uB), sel(qA, qB), sel(tA, tB)
        ssA2, uA2, qA2, tA2 = sel(ss_new, ssA), sel(u_new, uA), sel(q_new, qA), sel(T, tA)
        xcurv_next = sel(xcurv_next - lapshift, xcurv_next)
        k_in_lap2 = sel(torch.zeros_like(k_in_lap), k_in_lap + 1)
        lap_idx2 = lap_idx + crossing.long()

        lin_points_next = torch.cat([X[:, 1:], X[:, -1:]], dim=1)
        lin_input_next = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        z_warm_next = torch.cat([U[:, 1:].reshape(Bn, -1), U[:, -1], sol.z[:, n_u:]], dim=-1)

        live = lambda new, old: _lanes(~done, new, old)  # a finished lane stays frozen
        xcurv, xglob = live(xcurv_next, xcurv), live(xglob_next, xglob)
        ssA, uA, qA, tA = live(ssA2, ssA), live(uA2, uA), live(qA2, qA), live(tA2, tA)
        ssB, uB, qB, tB = live(ssB2, ssB), live(uB2, uB), live(qB2, qB), live(tB2, tB)
        lin_points, lin_input = live(lin_points_next, lin_points), live(lin_input_next, lin_input)
        u_prev, z_warm = live(u, u_prev), live(z_warm_next, z_warm)
        k_in_lap, lap_idx = live(k_in_lap2, k_in_lap), live(lap_idx2, lap_idx)
    xcurvs.append(xcurv)
    lap_ids, active = torch.stack(lap_ids, dim=1), ~torch.stack(dones, dim=1)
    lap_steps = torch.stack([(active & (lap_ids == j)).sum(dim=1) for j in range(n_laps)], dim=1)
    return (torch.stack(xcurvs, dim=1), torch.stack(us, dim=1), lap_steps.to(torch.int32),
            lap_idx.to(torch.int32))


def rollout_lmpc_learning(
    track,
    bike_params,
    lmpc_param,
    sys_param,
    xcurv0,
    xglob0,
    ss_prev,
    qfun_prev,
    u_prev_lap,
    t_prev: int,
    ss_prev2,
    qfun_prev2,
    u_prev2_lap,
    t_prev2: int,
    lin_points0,
    lin_input0,
    n_laps: int = 3,
    n_steps: int = 600,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    solves: list | None = None,
):
    """Multi-lap LMPC learning of one vehicle from ``xcurv0 (6,)``: the
    whole learning curve in one loop, each lap promoted into the safe set
    at its crossing (:func:`rollout_lmpc_learning_batch`, a batch of one).

    Returns (xcurv (n_steps+1, 6) with s wrapped per lap, u (n_steps, 2),
    lap_steps (n_laps,) int32, the learning curve, and laps_done () int32)."""
    xc, us, lap_steps, laps_done = rollout_lmpc_learning_batch(
        track, bike_params, lmpc_param, sys_param, xcurv0[None], xglob0[None],
        ss_prev, qfun_prev, u_prev_lap, t_prev, ss_prev2, qfun_prev2, u_prev2_lap, t_prev2,
        lin_points0, lin_input0, n_laps=n_laps, n_steps=n_steps, control_dt=control_dt,
        sub_dt=sub_dt, solves=solves)
    return xc[0], us[0], lap_steps[0], laps_done[0]


def polyder(coef):
    """``jnp.polyder`` of polynomials ``coef (..., deg+1)``, highest power first."""
    deg = coef.shape[-1] - 1
    return coef[..., :-1] * torch.arange(deg, 0, -1, dtype=coef.dtype, device=coef.device)


def polyval(coef, x):
    """``jnp.polyval``: polynomials ``coef (..., deg+1)`` (highest power
    first) at points ``x (T,)``, by Horner's rule from zero in
    ``jnp.polyval``'s order, each step one fused multiply-add as XLA
    compiles it.  Returns (..., T)."""
    y = torch.zeros(*coef.shape[:-1], *x.shape, dtype=x.dtype, device=x.device)
    for i in range(coef.shape[-1]):
        y = torch.addcmul(coef[..., i, None], y, x)
    return y


def _forecast(coef_s, coef_ey, t, N, control_dt):
    """Prescribed-motion predictions ``[vs, vey, 0, 0, s, ey]`` at times
    ``t + control_dt * (0..N)`` of obstacles whose s and ey follow the
    polynomials ``coef_s``/``coef_ey (..., deg+1)``; (..., N+1, 6)."""
    ts = t + control_dt * torch.arange(N + 1, dtype=t.dtype, device=t.device)
    s, ey = polyval(coef_s, ts), polyval(coef_ey, ts)
    vs, vey = polyval(polyder(coef_s), ts), polyval(polyder(coef_ey), ts)
    zeros = torch.zeros_like(s)
    return torch.stack([vs, vey, zeros, zeros, s, ey], dim=-1)


def rollout_mpccbf(
    track,
    bike_params,
    cbf_param,
    sys_param,
    xtarget,
    xcurv0,
    xglob0,
    obs_s_coef,
    obs_ey_coef,
    obs_active,
    obs_halfs,
    agent_half,
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    cold_iters: int = 40,
    warm_iters: int = 20,
    solves: list | None = None,
):
    """Closed-loop MPC-CBF racing of one vehicle from ``xcurv0 (6,)``
    among obstacles on a prescribed schedule (fused.py:83-177).

    Obstacle k's s and ey follow the polynomials ``obs_s_coef[k]`` and
    ``obs_ey_coef[k]`` of time (highest power first); it is considered when
    ``obs_active[k]`` and within ``obstacle_gate_mask``'s window.  Step 0
    solves cold with ``cold_iters`` iterations at t = 0; step k >= 1 at
    t = k * control_dt starts from the previous step's primal-dual iterate
    shifted one stage (``shift_cbf_warm``) and stops after ``warm_iters``.
    Every step then runs one control period through K1 and wraps s back by
    the lap length once it passes it.  If ``solves`` is a list, each
    step's solution (a batch of one) is appended to it.

    Returns (xcurv (n_steps+1, 6), u (n_steps, 2), kkt (n_steps-1,),
    iterations (n_steps-1,) int32): the KKT residuals and Newton iterations
    of the warm solves, as the JAX rollout reports them.
    """
    N = cbf_param.num_horizon
    dtype, dev = xcurv0.dtype, xcurv0.device
    n_obs = obs_s_coef.shape[0]
    L = track.lap_length.to(dtype)
    width = track.width.to(dtype)

    def solve(xcurv, t, warm, iters):
        obs_trajs = _forecast(obs_s_coef, obs_ey_coef, t, N, control_dt)  # (n_obs, N+1, 6)
        gate = controllers.obstacle_gate_mask(xcurv, obs_trajs[None, :, 0, 4], L)
        out = controllers.mpccbf(xcurv, xtarget, cbf_param, sys_param, width, obs_trajs[None],
                                 obs_active[None] & gate, agent_half, obs_halfs, L, warm=warm,
                                 return_traj=True, iters=iters)
        if solves is not None:
            solves.append(out[3])
        return out

    def advance(xcurv, xglob, u):
        xglob, xcurv = dynamics.propagate(track, bike_params, xglob, xcurv, u.contiguous(),
                                          control_dt=control_dt, sub_dt=sub_dt)
        s = xcurv[:, 4]
        xcurv = torch.cat([xcurv[:, :4], (s + torch.where(s > L, -L, 0.0))[:, None],
                           xcurv[:, 5:]], dim=1)
        return xcurv, xglob

    xcurv, xglob = xcurv0[None], xglob0[None]
    u, _, _, sol = solve(xcurv, torch.zeros((), dtype=dtype, device=dev), None, cold_iters)
    xcurvs, us, kkts, its = [xcurv0], [u[0]], [], []
    for k in range(n_steps - 1):
        xcurv, xglob = advance(xcurv, xglob, u)
        warm = controllers.shift_cbf_warm(sol, N, n_obs)
        t = (torch.tensor(float(k), dtype=dtype, device=dev) + 1.0) * control_dt
        u, _, _, sol = solve(xcurv, t, warm, warm_iters)
        xcurvs.append(xcurv[0])
        us.append(u[0])
        kkts.append(sol.kkt_res[0])
        its.append(sol.iterations[0])
    xcurv, _ = advance(xcurv, xglob, u)
    xcurvs.append(xcurv[0])
    stack = lambda xs, like: torch.stack(xs) if xs else like
    return (torch.stack(xcurvs), torch.stack(us),
            stack(kkts, xcurv0.new_zeros(0)),
            stack(its, torch.zeros(0, dtype=torch.int32, device=dev)))


def rollout_ilqr(
    track,
    bike_params,
    ilqr_param,
    xtarget,
    xcurv0,
    xglob0,
    obs_s_coef,
    obs_ey_coef,
    agent_half,
    obs_half,
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    warm_start: bool = True,
):
    """Closed-loop iLQR racing of one vehicle from ``xcurv0 (6,)`` behind
    one obstacle whose s and ey follow the polynomials ``obs_s_coef`` and
    ``obs_ey_coef (deg+1,)`` of time (fused.py:182-258).

    Step k forecasts the obstacle at t = k * control_dt, solves iLQR
    (``controllers.ilqr``), and runs one control period through K1.
    ``warm_start`` starts each solve from the previous step's input
    sequence shifted one stage; ``warm_start=False`` starts every solve
    from zeros, as the ``ilqr_ellipse`` golden does.

    Returns (xcurv (n_steps+1, 6), u (n_steps, 2), iterations (n_steps,)
    int32: each solve's Levenberg iterations).
    """
    N = ilqr_param.num_horizon
    dtype, dev = xcurv0.dtype, xcurv0.device
    xcurv, xglob = xcurv0[None], xglob0[None]
    u_warm = xcurv0.new_zeros(N, U_DIM)
    xcurvs, us, its = [xcurv0], [], []
    for k in range(n_steps):
        t = torch.tensor(float(k), dtype=dtype, device=dev) * control_dt
        obs_traj = _forecast(obs_s_coef, obs_ey_coef, t, N, control_dt)  # (N+1, 6)
        u, U, it = controllers.ilqr(xcurv[0], xtarget, ilqr_param, obs_traj, agent_half,
                                    obs_half, u_init=u_warm if warm_start else None,
                                    return_seq=True)
        xglob, xcurv = dynamics.propagate(track, bike_params, xglob, xcurv,
                                          u[None].contiguous(), control_dt=control_dt,
                                          sub_dt=sub_dt)
        u_warm = torch.cat([U[1:], U[-1:]])
        xcurvs.append(xcurv[0])
        us.append(u)
        its.append(it)
    return (torch.stack(xcurvs), torch.stack(us),
            torch.tensor(its, dtype=torch.int32, device=dev))
