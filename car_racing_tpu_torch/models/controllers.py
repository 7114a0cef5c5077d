"""Controllers (car_racing_tpu/models/controllers.py:38-139, 147-580,
674-809).

Ported so far: :func:`target_state`, :func:`pid`, :func:`lqr`, MPC-LTI
(:func:`mpc_lti`) with its dense condensed KKT and its two Riccati KKT
paths, LMPC, MPC-CBF (:func:`mpccbf` with :func:`obstacle_gate_mask` and
:func:`shift_cbf_warm`), the racing game's tracker
(:func:`mpc_multi_agents`) and iLQR (:func:`ilqr`).  Every function but
:func:`ilqr`, which solves for one vehicle as the JAX function does, takes
a leading batch of vehicles.
"""

from __future__ import annotations

import math

import torch

from ..ops import ipm, ocp, riccati
from ..utils.constants import U_DIM, X_DIM
from ..utils.device import resolve
from ..utils.params import ILQRParam, LMPCParam, LQRParam, MPCCBFParam, MPCParam, SystemParam


def target_state(vt, eyt, *, device="cuda", dtype=torch.float64):
    """``[vt, 0, 0, 0, 0, eyt]``."""
    return torch.tensor([float(vt), 0.0, 0.0, 0.0, 0.0, float(eyt)], dtype=dtype,
                        device=resolve(device))


def pid(xcurv: torch.Tensor, xtarget: torch.Tensor) -> torch.Tensor:
    """PID tracking of the target speed and lateral offset; (..., 2)."""
    delta = -0.6 * (xcurv[..., 5] - xtarget[..., 5]) - 0.9 * xcurv[..., 3]
    a = 1.5 * (xtarget[..., 0] - xcurv[..., 0])
    return torch.stack([delta, a], dim=-1)


def lqr(xcurv: torch.Tensor, xtarget: torch.Tensor, param: LQRParam) -> torch.Tensor:
    """LQR tracking of a batch of states ``xcurv (Bt, 6)``: ``-K (x -
    xtarget)`` with the gain of :func:`riccati.dare_iterate`
    (controllers.py:59-62), computed anew each call as there."""
    _, K = riccati.dare_iterate(param.A, param.B, param.Q, param.R, param.max_iter)
    return ((-K) @ (xcurv - xtarget).unsqueeze(-1)).squeeze(-1)


def _tracking_qp(param: MPCParam, sys_param: SystemParam, track_width, x0, xtarget):
    """Condensed MPC-LTI QP for a batch of states x0 (Bt, 6).

    H and the constraint rows depend only on (A, B) and are shared by the
    batch as expanded views; g and d carry the batch."""
    N = param.num_horizon
    Bt = x0.shape[0]
    phi, G = ocp.condense_lti(param.A, param.B, N, x0)
    x_targets = xtarget.unsqueeze(-2).expand(Bt, N, X_DIM)  # xtarget (6,) or (Bt, 6)
    H, g = ocp.quadratic_tracking_cost(phi, G, param.Q, param.R, x_targets, N)
    n_z = N * U_DIM
    u_min = torch.stack([-sys_param.delta_max, -sys_param.a_max])
    u_max = torch.stack([sys_param.delta_max, sys_param.a_max])
    C_u, d_u = ocp.input_box_rows(N, U_DIM, u_min, u_max, n_z)
    C_vx, d_vx = ocp.state_bound_rows(G, phi, 0, sys_param.v_min, sys_param.v_max, n_z)
    C_ey, d_ey = ocp.state_bound_rows(G, phi, 5, -track_width, track_width, n_z)
    C, d = ocp.stack_rows((C_u, d_u), (C_vx, d_vx), (C_ey, d_ey))
    E = H.new_zeros(Bt, 0, n_z)
    e = H.new_zeros(Bt, 0)
    qp = ipm.QP(H=H.expand(Bt, n_z, n_z), g=g, C=C.expand(Bt, *C.shape), d=d, E=E, e=e)
    return qp, phi, G


def mpc_lti(
    xcurv: torch.Tensor,
    xtarget: torch.Tensor,
    param: MPCParam,
    sys_param: SystemParam,
    track_width: torch.Tensor,
    u_warm: torch.Tensor | None = None,
    return_traj: bool = False,
    kkt: str = "dense",
    solves: list | None = None,
):
    """MPC tracking QP for a batch of states ``xcurv (Bt, 6)``: LTI
    dynamics, box input/state rows, track width.  ``u_warm (Bt, N*2)``
    warm-starts the interior point.  ``kkt`` picks the Newton step's
    factorization: ``"dense"`` condenses onto U and factors the (N*2)^2
    system; ``"riccati"`` solves the same QP through the stage-structured
    path of ``ipm.solve_ocp_qp``, one Riccati sweep per iteration;
    ``"riccati_parallel"`` takes that sweep's associative-scan form.  If
    ``solves`` is a list, the interior point's ``IPMSolution`` is appended
    to it.

    Returns u_0 (Bt, 2), and with ``return_traj`` also the open-loop inputs
    U (Bt, N, 2) and states X (Bt, N+1, 6)."""
    N = param.num_horizon
    if kkt in ("riccati", "riccati_parallel"):
        Bt = xcurv.shape[0]
        u_min = torch.stack([-sys_param.delta_max, -sys_param.a_max])
        u_max = torch.stack([sys_param.delta_max, sys_param.a_max])
        U0 = (u_warm.reshape(Bt, N, U_DIM) if u_warm is not None
              else xcurv.new_zeros(Bt, N, U_DIM))
        U, X, sol = ipm.solve_ocp_qp(
            param.A, param.B, param.Q, param.R, xcurv, xtarget, u_min, u_max, sys_param.v_min,
            sys_param.v_max, torch.as_tensor(track_width, dtype=xcurv.dtype, device=xcurv.device),
            U0, num_horizon=N, iters=30, stage_parallel=kkt == "riccati_parallel")
        if solves is not None:
            solves.append(sol)
        return (U[:, 0], U, X) if return_traj else U[:, 0]
    if kkt != "dense":
        raise ValueError(f"unknown kkt {kkt!r}")
    qp, phi, G = _tracking_qp(param, sys_param, track_width, xcurv, xtarget)
    z0 = u_warm if u_warm is not None else qp.g.new_zeros(xcurv.shape[0], N * U_DIM)
    sol = ipm.solve_qp(qp, z0, iters=30)
    if solves is not None:
        solves.append(sol)
    U = sol.z.reshape(-1, N, U_DIM)
    if return_traj:
        X = ocp.unpack_states(phi, G, sol.z, xcurv)
        return U[:, 0], U, X
    return U[:, 0]


def lmpc_qp(
    xcurv: torch.Tensor,
    param: LMPCParam,
    A_seq: torch.Tensor,
    B_seq: torch.Tensor,
    C_seq: torch.Tensor,
    ss_points: torch.Tensor,
    Qfun_points: torch.Tensor,
    u_prev: torch.Tensor,
    sys_param: SystemParam,
    lap_width: torch.Tensor,
    z_warm: torch.Tensor | None = None,
):
    """The LMPC step's QP for a batch of states ``xcurv (Bt, 6)``
    (controllers.py:752-802), over ``z = [U (N*2); lambda (K)]``.

    ``A_seq (N, 6, 6)``, ``B_seq (N, 6, 2)``, ``C_seq (N, 6)``: one
    linearization, shared by the batch, or one per state, ``(Bt, N, ...)``
    (a learning fleet).  ``ss_points (Bt, 6, K)``,
    ``Qfun_points (Bt, K)``: the selected safe-set points and their
    cost-to-go.  ``u_prev (Bt, 2)``: the input applied last.  The terminal
    state lies in the convex hull of the points (``x_N = SS lambda``,
    ``1'lambda = 1``, ``lambda >= 0``: 7 equality rows); the cost is input,
    input rate and ``Qfun . lambda``; ``vx <= v_max`` and ``|ey| <= width``
    hold at stages 1..N-1.  ``z_warm (Bt, N*2 + K)`` or, by default, zero
    inputs and ``lambda = 1/K`` start the interior point.

    Returns the QP (H and C shared by the batch as expanded views, unless
    the linearization is per state), z0 and the prediction matrices
    (phi (Bt, N*6), G (N*6, N*2) or, per state, (Bt, N*6, N*2))."""
    N = param.num_horizon
    Bt = xcurv.shape[0]
    K = Qfun_points.shape[-1]
    dtype, dev = xcurv.dtype, xcurv.device
    phi, G = ocp.condense(A_seq, B_seq, C_seq, xcurv)
    n_u = N * U_DIM
    n_z = n_u + K

    x_track = torch.tensor([5.0, 0, 0, 0, 0, 0], dtype=dtype, device=dev)
    H_u, g_u = ocp.quadratic_tracking_cost(phi, G, param.Q, param.R,
                                           x_track.expand(Bt, N, X_DIM), N)
    H_dr, g_dr = ocp.input_rate_cost(param.dR, N, u_prev)
    lanes = G.shape[:-2]  # () for a shared linearization, else (Bt,)
    H = xcurv.new_zeros(*lanes, n_z, n_z)
    H[..., :n_u, :n_u] = H_u + H_dr
    g = torch.cat([g_u + g_dr, Qfun_points], dim=-1)

    # terminal equality: x_N(U) - SS lambda = 0 ; sum lambda = 1
    E = xcurv.new_zeros(Bt, X_DIM + 1, n_z)
    E[:, :X_DIM, :n_u] = G[..., -X_DIM:, :]
    E[:, :X_DIM, n_u:] = -ss_points
    E[:, X_DIM, n_u:] = 1.0
    e = torch.cat([-phi[:, -X_DIM:], xcurv.new_ones(Bt, 1)], dim=-1)

    # inequalities: the input box; vx <= v_max and |ey| <= width at stages
    # 1..N-1 (stage N lies in the safe-set hull); lambda >= 0
    u_min = torch.stack([-sys_param.delta_max, -sys_param.a_max])
    u_max = torch.stack([sys_param.delta_max, sys_param.a_max])
    C_u, d_u = ocp.input_box_rows(N, U_DIM, u_min, u_max, n_z)
    sel = torch.arange(N - 1, device=dev) * X_DIM
    G_vx = xcurv.new_zeros(*lanes, N - 1, n_z)
    G_vx[..., :n_u] = G[..., sel, :]
    G_ey = xcurv.new_zeros(*lanes, N - 1, n_z)
    G_ey[..., :n_u] = G[..., sel + 5, :]
    p_vx, p_ey = phi[:, sel], phi[:, sel + 5]
    C_lam = xcurv.new_zeros(K, n_z)
    C_lam[:, n_u:] = torch.eye(K, dtype=dtype, device=dev)
    per_lane = lambda rows: rows.expand(*lanes, *rows.shape)
    C = torch.cat([per_lane(C_u), -G_vx, G_ey, -G_ey, per_lane(C_lam)], dim=-2)
    d = torch.cat([
        d_u.expand(Bt, -1),
        p_vx - sys_param.v_max,
        -lap_width - p_ey,
        p_ey - lap_width,
        xcurv.new_zeros(Bt, K),
    ], dim=-1)

    qp = ipm.QP(H=H.expand(Bt, n_z, n_z), g=g, C=C.expand(Bt, *C.shape[-2:]), d=d, E=E, e=e)
    if z_warm is None:
        z_warm = xcurv.new_zeros(Bt, n_z)
        z_warm[:, n_u:] = 1.0 / K
    return qp, z_warm, phi, G


LMPC_ITERS = 40  # the LMPC solve's iteration cap (controllers.py:806)


def lmpc(
    xcurv: torch.Tensor,
    param: LMPCParam,
    A_seq: torch.Tensor,
    B_seq: torch.Tensor,
    C_seq: torch.Tensor,
    ss_points: torch.Tensor,
    Qfun_points: torch.Tensor,
    u_prev: torch.Tensor,
    sys_param: SystemParam,
    lap_width: torch.Tensor,
    z_warm: torch.Tensor | None = None,
):
    """LMPC step (controllers.py:729-809) for a batch of states ``xcurv
    (Bt, 6)``: the QP of :func:`lmpc_qp`, solved by the dense interior
    point with its bordered-KKT LU (``ipm.solve_qp``, ``LMPC_ITERS``), as the
    JAX package solves it.

    Returns U (Bt, N, 2), X (Bt, N+1, 6) and the IPMSolution."""
    N = param.num_horizon
    qp, z0, phi, G = lmpc_qp(xcurv, param, A_seq, B_seq, C_seq, ss_points, Qfun_points,
                             u_prev, sys_param, lap_width, z_warm)
    sol = ipm.solve_qp(qp, z0, iters=LMPC_ITERS)
    n_u = N * U_DIM
    U = sol.z[:, :n_u].reshape(-1, N, U_DIM)
    X = ocp.unpack_states(phi, G, sol.z[:, :n_u], xcurv)
    return U, X, sol


# ---------------------------------------------------------------------------
# iLQR with a CBF repelling cost (controllers.py:147-264)
# ---------------------------------------------------------------------------


def _ilqr_cost_terms(param: ILQRParam, xvar, uvar, xtarget, obs_traj, agent_half, obs_half):
    """Stage cost derivatives with the CBF repelling term
    (controllers.py:147-176).

    xvar (N+1, 6) the current trajectory, uvar (N, 2), obs_traj (N or N+1,
    6) the one obstacle over the horizon.  Returns l_x (N, 6), l_u (N, 2),
    l_xx (N, 6, 6), l_uu (N, 2, 2)."""
    N = uvar.shape[0]
    Q, R = param.Q, param.R
    safety_margin = 0.15
    q1 = q2 = 2.5
    l_half, w_half = agent_half[0] + obs_half[0], agent_half[1] + obs_half[1]
    zero = torch.zeros_like(l_half)
    P_diag = torch.stack([zero, zero, zero, zero, 1.0 / (l_half * l_half),
                          1.0 / (w_half * w_half)])

    xk, obs = xvar[:N], obs_traj[:N]
    dx = xk - xtarget
    l_x = dx @ (2 * Q).T
    l_xx = 2 * Q
    l_u = uvar @ (2 * R).T
    l_uu = 2 * R
    diff = torch.zeros_like(xk)
    diff[:, 4] = xk[:, 4] - obs[:, 4]
    diff[:, 5] = xk[:, 5] - obs[:, 5]
    h = 1.0 + safety_margin - (P_diag * diff * diff).sum(dim=-1)
    h_dot = -2.0 * P_diag * diff
    e = torch.exp(q2 * h)[:, None]
    b_dot = q1 * q2 * e * h_dot
    b_ddot = (q1 * q2**2 * e)[:, :, None] * (h_dot[:, :, None] * h_dot[:, None, :])
    return l_x + b_dot, l_u, l_xx + b_ddot, l_uu.expand(N, U_DIM, U_DIM)


def ilqr(xcurv, xtarget, param: ILQRParam, obs_traj, agent_half, obs_half,
         u_init=None, return_seq: bool = False):
    """iLQR on the LTI model with a CBF repelling obstacle cost, for one
    vehicle ``xcurv (6,)`` (controllers.py:179-264).

    Forward rollout, eigenvalue-clamped backward pass, accept/reject with a
    Levenberg schedule (x10 on a rejected step, /10 on an accepted one; done
    above 1000, or when an accepted step changes the cost by less than 1 %),
    at most ``param.max_iter`` iterations; one flag is read back to the host
    per iteration.  ``u_init (N, 2)`` warm-starts the input sequence (zeros
    by default).  Returns u_0 (2,), or with ``return_seq`` (u_0, U (N, 2),
    iterations)."""
    N = param.num_horizon
    A, B, Q, R = param.A, param.B, param.Q, param.R
    dtype = xcurv.dtype

    def rollout(uvar):
        x, xs = xcurv, [xcurv]
        for t in range(N):
            x = A @ x + B @ uvar[t]
            xs.append(x)
        return torch.stack(xs)

    def total_cost(xvar, uvar):
        dx = xvar - xtarget
        return ((dx @ Q) * dx).sum() + ((uvar @ R) * uvar).sum()

    uvar = xcurv.new_zeros(N, U_DIM) if u_init is None else u_init.to(dtype)
    xvar = rollout(uvar)
    cost = total_cost(xvar, uvar)
    lamb = torch.ones((), dtype=dtype, device=xcurv.device)
    f_x, f_u = A.expand(N, *A.shape), B.expand(N, *B.shape)
    Vxx_T = 2 * Q
    it = 0
    while it < param.max_iter:
        l_x, l_u, l_xx, l_uu = _ilqr_cost_terms(param, xvar, uvar, xtarget, obs_traj,
                                                agent_half, obs_half)
        Vx_T = 2 * Q @ (xvar[N] - xtarget)
        ks, Ks = riccati.tvlqr_backward(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T, lamb)
        xs_new, us_new = riccati.tvlqr_rollout(A, B, xcurv, uvar, xvar[:N], ks, Ks)
        cost_new = total_cost(xs_new, us_new)
        accept = cost_new < cost
        conv = ((cost_new - cost) / cost.abs().clamp_min(1e-12)).abs() < 0.01
        uvar = torch.where(accept, us_new, uvar)
        xvar = torch.where(accept, xs_new, xvar)
        cost = torch.where(accept, cost_new, cost)
        # XLA folds the JAX code's `lamb / 10.0` into `lamb * 0.1`, whose
        # rounding decides `lamb_next > 1000` after a run of rejections
        lamb_next = torch.where(accept, lamb * 0.1, lamb * 10.0)
        done = (accept & conv) | (lamb_next > 1000.0)
        lamb = torch.where(done, lamb, lamb_next)
        it += 1
        if bool(done):
            break
    if return_seq:
        return uvar[0], uvar, it
    return uvar[0]


# ---------------------------------------------------------------------------
# MPC-CBF (controllers.py:267-521, 674-724)
# ---------------------------------------------------------------------------

# warm-start caps (controllers.py:278-280): slacks and IPM slack estimates
# restart from moderate values after deeply violated episodes; the
# multiplier cap stays above the 1e4 slack-penalty weight
WARM_SLACK_MAX = 10.0
WARM_LAM_MAX = 2e4
WARM_S_MAX = 100.0


def _pow5(x):
    """``x**5`` as JAX's ``integer_pow`` multiplies it out: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


def _pow6(x):
    """``x**6`` as JAX's ``integer_pow`` multiplies it out: x^2 * (x^2)^2."""
    x2 = x * x
    return x2 * (x2 * x2)


def obstacle_gate_mask(xcurv, obs_first_s, lap_length, safety_time=2.0):
    """Obstacle k is considered iff its wrapped s lies within
    ``vx * safety_time`` of the ego's (controllers.py:283-289).  xcurv
    (Bt, 6), obs_first_s (Bt, n_obs); returns (Bt, n_obs) bool."""
    margin = (xcurv[:, 0] * safety_time)[:, None]
    dist_ego = torch.remainder(xcurv[:, 4], lap_length)[:, None]
    dist_obs = torch.remainder(obs_first_s, lap_length)
    return (dist_ego > dist_obs - margin) & (dist_ego < dist_obs + margin)


def _cbf_nlp(xcurv, x_targets, A, B, Q, R, N: int, sys_param: SystemParam, track_width,
             obs_trajs, obs_mask, agent_half, obs_halfs, lap_length, alpha, safety_margin,
             warm, iters: int, warm_select=None, iters_warm: int | None = None):
    """The CBF-constrained MPC of :func:`mpccbf` for a batch of states
    ``xcurv (Bt, 6)`` (controllers.py:292-472).

    z = [U (N*2); slacks (n_obs*(N+1))].  The objective is the condensed
    tracking cost of ``x_targets (Bt, N, 6)`` plus 1e4 per slack of an
    active obstacle; the linear rows are the input box, vx and ey bounds and
    slack >= 0; the nonlinear rows are the discrete CBF conditions
    ``h_{k+1} - (1 - alpha) h_k >= 0`` of the degree-6 superellipse barrier
    per obstacle, with their Jacobian in closed form through the condensed
    s and ey rows.  ``obs_trajs (Bt, n_obs, N+1, 6)`` are the obstacles'
    predictions, ``obs_mask (Bt, n_obs)`` the obstacles considered (rows of
    the others read 1 with a zero Jacobian), ``agent_half (2,)`` and
    ``obs_halfs (n_obs, 2)`` half lengths and widths.  ``warm`` is None
    (cold: U = 0, slacks 0.1) or the previous (z, lam, s), capped; with
    ``warm_select = (use_warm (Bt,), (z, lam, s))`` each problem picks at
    run time between the two, the warm ones capped at ``iters_warm``
    iterations.  Returns U (Bt, N, 2), X (Bt, N+1, 6) and the solution."""
    Bt = xcurv.shape[0]
    n_obs = obs_trajs.shape[-3]
    dtype, dev = xcurv.dtype, xcurv.device
    opts = dict(dtype=dtype, device=dev)

    phi, G = ocp.condense_lti(A, B, N, xcurv)
    n_u = N * U_DIM
    n_slack = n_obs * (N + 1)
    n_z = n_u + n_slack
    num_cycle_ego = torch.floor(xcurv[:, 4] / lap_length)

    # stage maps t_s = p_s + G_s U and t_ey likewise, stages 0..N
    sel_s = torch.arange(N, device=dev) * X_DIM + 4
    sel_ey = sel_s + 1
    sel_vx = sel_s - 4
    zrow = xcurv.new_zeros(1, n_u)
    G_s_all = torch.cat([zrow, G[sel_s]])  # (N+1, n_u)
    G_ey_all = torch.cat([zrow, G[sel_ey]])
    p_s_all = torch.cat([xcurv[:, 4:5], phi[:, sel_s]], dim=-1)  # (Bt, N+1)
    p_ey_all = torch.cat([xcurv[:, 5:6], phi[:, sel_ey]], dim=-1)

    # quadratic objective over z
    x_t_flat = x_targets.expand(Bt, N, X_DIM).reshape(Bt, N * X_DIM)
    eyeN = torch.eye(N, **opts)
    Qbar, Rbar = torch.kron(eyeN, Q), torch.kron(eyeN, R)
    H_u = 2.0 * (G.T @ Qbar @ G + Rbar)
    g_u = 2.0 * ((phi - x_t_flat) @ Qbar.T @ G)
    H = torch.zeros(n_z, n_z, **opts)
    H[:n_u, :n_u] = H_u
    H = H + 1e-9 * torch.eye(n_z, **opts)
    slack_w = torch.where(obs_mask[..., None], 1e4, 0.0) * torch.ones(n_obs, N + 1, **opts)
    g = torch.cat([g_u, slack_w.reshape(Bt, n_slack)], dim=-1)

    # linear rows: input box, vx and ey bounds, slack >= 0
    I_u = torch.zeros(n_u, n_z, **opts)
    I_u[:, :n_u] = torch.eye(n_u, **opts)
    Gv = torch.zeros(N, n_z, **opts)
    Gv[:, :n_u] = G[sel_vx]
    Ge = torch.zeros(N, n_z, **opts)
    Ge[:, :n_u] = G[sel_ey]
    I_sl = torch.zeros(n_slack, n_z, **opts)
    I_sl[:, n_u:] = torch.eye(n_slack, **opts)
    u_lo = torch.stack([-sys_param.delta_max, -sys_param.a_max]).repeat(N)
    u_hi = torch.stack([sys_param.delta_max, sys_param.a_max]).repeat(N)
    C_lin = torch.cat([I_u, -I_u, -Gv, Gv, -Ge, Ge, I_sl])
    p_vx, p_ey = phi[:, sel_vx], phi[:, sel_ey]
    d_lin = torch.cat([
        u_lo.expand(Bt, n_u),
        (-u_hi).expand(Bt, n_u),
        p_vx - sys_param.v_max,
        sys_param.v_min - p_vx,
        p_ey - track_width,
        -track_width - p_ey,
        xcurv.new_zeros(Bt, n_slack),
    ], dim=-1)

    # nonlinear CBF rows with a closed-form Jacobian
    L6 = _pow6(agent_half[..., 0, None] + obs_halfs[..., 0])[..., None]  # (n_obs, 1)
    W6 = _pow6(agent_half[..., 1, None] + obs_halfs[..., 1])[..., None]
    num_cycle_obs = torch.floor(obs_trajs[..., 0, 4] / lap_length)  # (Bt, n_obs)
    wrap_off = ((num_cycle_ego[:, None] - num_cycle_obs) * lap_length)[..., None]
    o_s, o_ey = obs_trajs[..., 4], obs_trajs[..., 5]  # (Bt, n_obs, N+1)
    one_m_alpha = 1.0 - alpha
    eyeN1 = torch.eye(N + 1, **opts)
    J_sl_stage = -eyeN1[1:] + one_m_alpha * eyeN1[:N]  # (N, N+1)
    J_sl = torch.kron(torch.eye(n_obs, **opts), J_sl_stage)  # (n_obs*N, n_slack)
    row_mask = obs_mask.repeat_interleave(N, dim=-1)[..., None]  # (Bt, n_obs*N, 1)

    def c_nl(z):
        t_s = p_s_all + z[:, :n_u] @ G_s_all.T  # (Bt, N+1)
        t_ey = p_ey_all + z[:, :n_u] @ G_ey_all.T
        sl = z[:, n_u:].reshape(Bt, n_obs, N + 1)
        # h_k gets the lap-wrap shift, h_{k+1} does not (control.py:539-543)
        ds_k = t_s[:, None, :N] - o_s[..., :N] - wrap_off  # (Bt, n_obs, N)
        ds_n = t_s[:, None, 1:] - o_s[..., 1:]
        de_k = t_ey[:, None, :N] - o_ey[..., :N]
        de_n = t_ey[:, None, 1:] - o_ey[..., 1:]
        h_k = _pow6(ds_k) / L6 + _pow6(de_k) / W6 - 1.0 - safety_margin - sl[..., :N]
        h_n = _pow6(ds_n) / L6 + _pow6(de_n) / W6 - 1.0 - safety_margin - sl[..., 1:]
        vals = h_n - one_m_alpha * h_k
        vals = torch.where(obs_mask[..., None], vals, 1.0)

        dv_dts_n = 6 * _pow5(ds_n) / L6
        dv_dts_k = -one_m_alpha * 6 * _pow5(ds_k) / L6
        dv_dte_n = 6 * _pow5(de_n) / W6
        dv_dte_k = -one_m_alpha * 6 * _pow5(de_k) / W6
        J_U = (dv_dts_n[..., None] * G_s_all[1:]
               + dv_dts_k[..., None] * G_s_all[:N]
               + dv_dte_n[..., None] * G_ey_all[1:]
               + dv_dte_k[..., None] * G_ey_all[:N])  # (Bt, n_obs, N, n_u)
        J = torch.cat([J_U.reshape(Bt, n_obs * N, n_u), J_sl.expand(Bt, -1, -1)], dim=-1)
        J = torch.where(row_mask, J, 0.0)
        return vals.reshape(Bt, n_obs * N), J

    z_cold = xcurv.new_zeros(Bt, n_z)
    z_cold[:, n_u:] = 0.1

    def sanitized(zw, lamw, sw):
        zw = torch.cat([zw[:, :n_u], zw[:, n_u:].clamp(0.1, WARM_SLACK_MAX)], dim=-1)
        return zw, lamw.clamp(1e-3, WARM_LAM_MAX), sw.clamp(1e-2, WARM_S_MAX)

    qp_args = (H.expand(Bt, n_z, n_z), g, C_lin.expand(Bt, *C_lin.shape), d_lin, c_nl)
    if warm_select is not None:
        if warm is not None:
            raise ValueError("pass either warm (static config) or warm_select (runtime "
                             "cold/warm selection), not both")
        use_warm, triple = warm_select
        zw, lam0, s0 = sanitized(*triple)
        z0 = torch.where(use_warm[:, None], zw, z_cold)
        cap = torch.where(use_warm, iters if iters_warm is None else iters_warm, iters)
        sol = ipm.solve_qp_nl(*qp_args, z0, lam0=lam0, s0=s0, iters=iters, warm_if=use_warm,
                              iters_cap=cap)
    elif warm is None:
        sol = ipm.solve_qp_nl(*qp_args, z_cold, iters=iters)
    else:
        z0, lam0, s0 = sanitized(*warm)
        sol = ipm.solve_qp_nl(*qp_args, z0, lam0=lam0, s0=s0, iters=iters)
    U = sol.z[:, :n_u].reshape(Bt, N, U_DIM)
    return U, ocp.unpack_states(phi, G, sol.z[:, :n_u], xcurv), sol


def mpccbf(xcurv, xtarget, param: MPCCBFParam, sys_param: SystemParam, track_width,
           obs_trajs, obs_mask, agent_half, obs_halfs, lap_length, warm=None,
           return_traj: bool = False, iters: int = 40):
    """MPC with discrete-time control-barrier-function rows per obstacle
    (controllers.py:475-521), for a batch of states ``xcurv (Bt, 6)``: the
    problem of :func:`_cbf_nlp` with the target ``xtarget (6,)`` or
    ``(Bt, 6)`` at every stage, safety margin 0.2 and ``param.alpha``.
    Returns u_0 (Bt, 2), and with ``return_traj`` (u_0, U, X, solution)."""
    N = param.num_horizon
    Bt = xcurv.shape[0]
    x_targets = xtarget.unsqueeze(-2).expand(Bt, N, X_DIM)
    U, X, sol = _cbf_nlp(xcurv, x_targets, param.A, param.B, param.Q, param.R, N, sys_param,
                         track_width, obs_trajs, obs_mask, agent_half, obs_halfs, lap_length,
                         param.alpha, 0.2, warm, iters=iters)
    if return_traj:
        return U[:, 0], U, X, sol
    return U[:, 0]


def mpc_multi_agents(xcurv, x_targets, A, B, Q, R, sys_param: SystemParam, track_width,
                     obs_trajs, obs_mask, agent_half, obs_halfs, lap_length, warm=None,
                     iters: int = 40, warm_select=None, iters_warm: int | None = None):
    """The racing game's overtake tracker (controllers.py:525-580) for a
    batch of states ``xcurv (Bt, 6)``: the problem of :func:`_cbf_nlp` with
    safety margin 0.15 and alpha 0.6, tracking the per-stage targets
    ``x_targets (Bt, N, 6)`` (the planned trajectory's ey over the predicted
    s) with the racing game's LTI model and costs ``A, B, Q, R``.
    ``warm_select=(use_warm (Bt,), (z, lam, s))`` with ``iters_warm``
    starts each problem cold (``iters`` iterations) or from its triple
    (capped at ``iters_warm``), chosen per problem at run time.
    Returns (u_0 (Bt, 2), U, X, solution)."""
    N = x_targets.shape[-2]
    U, X, sol = _cbf_nlp(xcurv, x_targets, A, B, Q, R, N, sys_param, track_width, obs_trajs,
                         obs_mask, agent_half, obs_halfs, lap_length,
                         torch.tensor(0.6, dtype=xcurv.dtype, device=xcurv.device), 0.15, warm,
                         iters=iters, warm_select=warm_select, iters_warm=iters_warm)
    return U[:, 0], U, X, sol


def _stage_shift(a, dim=0):
    """Shift one stage forward along ``dim``, repeating the final stage."""
    n = a.shape[dim]
    idx = torch.arange(1, n + 1, device=a.device).clamp_max(n - 1)
    return a.index_select(dim, idx)


def shift_cbf_warm(sol: ipm.IPMSolution, N: int, n_obs: int):
    """Shift a batch of CBF primal-dual iterates one control period forward,
    repeating the last stage: the next step's warm start (controllers.py:
    681-724).  z = [U (N*2); slacks (n_obs*(N+1))]; the multipliers and
    slacks follow :func:`_cbf_nlp`'s rows: input lower and upper bounds
    (2 x N x 2), vx and ey bounds (4 x N), slack >= 0 (n_obs x (N+1)), CBF
    (n_obs x N).  Returns (z, lam, s), each (Bt, ...)."""
    n_u = N * U_DIM
    layout = (((N, U_DIM), 0), ((N, U_DIM), 0), ((N,), 0), ((N,), 0), ((N,), 0), ((N,), 0),
              ((n_obs, N + 1), 1), ((n_obs, N), 1))

    def shift_all(vec):
        Bt = vec.shape[0]
        parts, o = [], 0
        for shape, dim in layout:
            size = math.prod(shape)
            block = vec[:, o:o + size].reshape(Bt, *shape)
            parts.append(_stage_shift(block, dim + 1).reshape(Bt, size))
            o += size
        return torch.cat(parts, dim=-1)

    Bt = sol.z.shape[0]
    u_shift = _stage_shift(sol.z[:, :n_u].reshape(Bt, N, U_DIM), 1).reshape(Bt, n_u)
    sl_shift = _stage_shift(sol.z[:, n_u:].reshape(Bt, n_obs, N + 1), 2).reshape(Bt, -1)
    return torch.cat([u_shift, sl_shift], dim=-1), shift_all(sol.lam), shift_all(sol.s)
