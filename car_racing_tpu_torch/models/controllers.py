"""Controllers (car_racing_tpu/models/controllers.py:38-139).

Ported so far: :func:`target_state`, :func:`pid` and MPC-LTI with the dense
condensed KKT (``kkt="dense"``).  Every function takes a leading batch of
vehicles; the Riccati variants are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import ipm, ocp
from ..utils.constants import U_DIM, X_DIM
from ..utils.device import resolve
from ..utils.params import MPCParam, SystemParam


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
