"""Tracking policies (car_racing_tpu/racing/policies.py:31-166): host-side
lifecycle shells over the controllers of :mod:`..models.controllers`.

Each policy keeps time and lap bookkeeping, solves on its track's device,
and records every solve's wall time, its input back on the host, in
``GLOBAL_TIMER``.  The ego's planner-artifact logs get ``None`` rows each
step, as in the JAX package, so plotting code can index them uniformly.
The racing policies (``iLQRRacing``, ``MPCCBFRacing``, the LMPC racing
game) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import controllers
from ..utils.constants import U_DIM
from ..utils.params import LQRParam, MPCParam, SystemParam
from ..utils.profiling import GLOBAL_TIMER


class ControlBase:
    """Lifecycle and memory (policies.py:31-101)."""

    def __init__(self):
        self.agent_name = None
        self.time = 0.0
        self.timestep = None
        self.x = None
        self.xglob = None
        self.u = None
        self.realtime_flag = False
        self.lap_times, self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], [], []
        self.lap_times.append(self.time)
        self.times, self.xglobs, self.xcurvs, self.inputs = [], [], [], []
        self.laps = 0
        self.track = None
        self.opti_traj_xcurv = None
        self.opti_traj_xglob = None
        self.racing_sim = None

    def set_track(self, track):
        self.track = track
        self.lap_length = float(track.lap_length)
        self.lap_width = float(track.width)

    def set_opti_traj(self, opti_traj_xcurv, opti_traj_xglob):
        self.opti_traj_xcurv = opti_traj_xcurv
        self.opti_traj_xglob = opti_traj_xglob

    def set_racing_sim(self, racing_sim):
        self.racing_sim = racing_sim

    def set_timestep(self, timestep):
        self.timestep = timestep

    def set_target_speed(self, vt):
        self.vt = vt

    def set_target_deviation(self, eyt):
        self.eyt = eyt

    def set_state(self, xcurv, xglob):
        self.x = xcurv
        self.xglob = xglob

    def calc_input(self):
        raise NotImplementedError

    def get_input(self):
        return self.u

    def _log_none_artifacts(self, solve_ms=None):
        """Placeholder artifact rows for the ego; ``solve_ms`` records the
        step's solve latency."""
        if self.agent_name != "ego" or self.racing_sim is None:
            return
        ego = self.racing_sim.vehicles.get("ego")
        if ego is None:
            return
        ego.local_trajs.append(None)
        ego.vehicles_interest.append(None)
        ego.splines.append(None)
        ego.solver_time.append(solve_ms)
        ego.all_splines.append(None)
        ego.all_local_trajs.append(None)
        ego.lmpc_prediction.append(None)
        ego.mpc_cbf_prediction.append(None)

    def _xtarget(self):
        return np.array([self.vt, 0, 0, 0, 0, self.eyt])

    def _tensor(self, a):
        """A host array on the track's device, in the track's dtype."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.track.lap_length.dtype,
                               device=self.track.lap_length.device)

    @staticmethod
    def _host(t):
        return t.cpu().numpy().astype(np.float64)


class PIDTracking(ControlBase):
    """(policies.py:104-116)"""

    def __init__(self, vt=0.6, eyt=0.0):
        super().__init__()
        self.set_target_speed(vt)
        self.set_target_deviation(eyt)

    def calc_input(self):
        with GLOBAL_TIMER.measure("pid"):
            self.u = self._host(controllers.pid(self._tensor(self.x),
                                                self._tensor(self._xtarget())))
        self._log_none_artifacts(GLOBAL_TIMER.samples["pid"][-1])
        self.time += self.timestep


class LQRTracking(ControlBase):
    """(policies.py:119-135)"""

    def __init__(self, lqr_param: LQRParam | None = None, system_param: SystemParam | None = None):
        super().__init__()
        self.lqr_param = lqr_param or LQRParam.default()
        self.system_param = system_param or SystemParam.default(device=self.lqr_param.A.device,
                                                                dtype=self.lqr_param.A.dtype)
        self.set_target_speed(float(self.lqr_param.vt))
        self.set_target_deviation(float(self.lqr_param.eyt))

    def calc_input(self):
        with GLOBAL_TIMER.measure("lqr"):
            self.u = self._host(controllers.lqr(self._tensor(self.x)[None],
                                                self._tensor(self._xtarget()), self.lqr_param)[0])
        self._log_none_artifacts(GLOBAL_TIMER.samples["lqr"][-1])
        self.time += self.timestep


class MPCTracking(ControlBase):
    """(policies.py:138-166) The dense MPC-LTI solve, warm-started by the
    previous solution shifted one stage."""

    def __init__(self, mpc_lti_param: MPCParam | None = None,
                 system_param: SystemParam | None = None):
        super().__init__()
        self.mpc_lti_param = mpc_lti_param or MPCParam.default()
        self.system_param = system_param or SystemParam.default(
            device=self.mpc_lti_param.A.device, dtype=self.mpc_lti_param.A.dtype)
        self.set_target_speed(float(self.mpc_lti_param.vt))
        self.set_target_deviation(float(self.mpc_lti_param.eyt))
        self._u_warm = None

    def calc_input(self):
        with GLOBAL_TIMER.measure("mpc_lti"):
            u0, U, _ = controllers.mpc_lti(
                self._tensor(self.x)[None],
                self._tensor(self._xtarget()),
                self.mpc_lti_param,
                self.system_param,
                self.track.width,
                u_warm=self._u_warm,
                return_traj=True,
            )
            self.u = self._host(u0[0])
        flat = U.reshape(1, -1)
        self._u_warm = torch.cat([flat[:, U_DIM:], flat[:, -U_DIM:]], dim=1)
        self._log_none_artifacts(GLOBAL_TIMER.samples["mpc_lti"][-1])
        self.time += self.timestep
