"""Controllers (car_racing_tpu/models/controllers.py:38-139, 729-809).

Ported so far: :func:`target_state`, :func:`pid`, MPC-LTI with the dense
condensed KKT (``kkt="dense"``) and LMPC.  Every function takes a leading
batch of vehicles; the Riccati variants are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import ipm, ocp
from ..utils.constants import U_DIM, X_DIM
from ..utils.device import resolve
from ..utils.params import LMPCParam, MPCParam, SystemParam


def target_state(vt, eyt, *, device="cuda", dtype=torch.float64):
    """``[vt, 0, 0, 0, 0, eyt]``."""
    return torch.tensor([float(vt), 0.0, 0.0, 0.0, 0.0, float(eyt)], dtype=dtype,
                        device=resolve(device))


def pid(xcurv: torch.Tensor, xtarget: torch.Tensor) -> torch.Tensor:
    """PID tracking of the target speed and lateral offset; (..., 2)."""
    delta = -0.6 * (xcurv[..., 5] - xtarget[..., 5]) - 0.9 * xcurv[..., 3]
    a = 1.5 * (xtarget[..., 0] - xcurv[..., 0])
    return torch.stack([delta, a], dim=-1)


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
):
    """MPC tracking QP for a batch of states ``xcurv (Bt, 6)``: LTI
    dynamics, box input/state rows, track width.  ``u_warm (Bt, N*2)``
    warm-starts the interior point.

    Returns u_0 (Bt, 2), and with ``return_traj`` also the open-loop inputs
    U (Bt, N, 2) and states X (Bt, N+1, 6)."""
    N = param.num_horizon
    qp, phi, G = _tracking_qp(param, sys_param, track_width, xcurv, xtarget)
    z0 = u_warm if u_warm is not None else qp.g.new_zeros(xcurv.shape[0], N * U_DIM)
    sol = ipm.solve_qp(qp, z0, iters=30)
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
    point with its bordered-KKT LU (``ipm.solve_qp``, 40 iterations), as the
    JAX package solves it.

    Returns U (Bt, N, 2), X (Bt, N+1, 6) and the IPMSolution."""
    N = param.num_horizon
    qp, z0, phi, G = lmpc_qp(xcurv, param, A_seq, B_seq, C_seq, ss_points, Qfun_points,
                             u_prev, sys_param, lap_width, z_warm)
    sol = ipm.solve_qp(qp, z0, iters=40)
    n_u = N * U_DIM
    U = sol.z[:, :n_u].reshape(-1, N, U_DIM)
    X = ocp.unpack_states(phi, G, sol.z[:, :n_u], xcurv)
    return U, X, sol
