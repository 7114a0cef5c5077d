"""Vehicle models (car_racing_tpu/racing/vehicles.py): host-side stateful
shells around the port's tensor functions.

The simulator steps vehicles through ``forward_one_step`` and reads their
lap-structured logs.  Host state (``xcurv``, ``xglob``, ``u``, the logs)
stays numpy float64, as in the JAX package; each step moves the state to
the track's device, where :func:`dynamics.propagate` runs one control
period (kernel K1 on the card, its plain loop on the CPU).  Vehicles build
their parameters on ``device`` (default ``"cuda"``) and take a track on the
same device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dynamics, track as track_ops
from ..utils.constants import U_DIM
from ..utils.params import CarParam, SystemParam


class ModelBase:
    """Lap-structured logging and lifecycle (vehicles.py:31-136)."""

    def __init__(self, name=None, param: CarParam | None = None, system_param=None, *,
                 device="cuda", dtype=torch.float64):
        self.name = name
        self.param = param or CarParam.default(device=device, dtype=dtype)
        self.device = self.param.length.device
        self.dtype = dtype
        self.system_param = system_param
        self.no_dynamics = False
        self.time = 0.0
        self.timestep = None
        self.xcurv = None
        self.xglob = None
        self.u = None
        self.zero_noise_flag = False
        self.laps = 0
        self.realtime_flag = False
        self.track = None
        self.ctrl_policy = None
        self.lap_times, self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], [], []
        self.lap_times.append(self.time)
        self.times, self.xglobs, self.xcurvs, self.inputs = [], [], [], []
        self.xglob_log, self.xcurv_log = [], []
        self.local_trajs, self.vehicles_interest = [], []
        self.splines, self.solver_time = [], []
        self.all_splines, self.all_local_trajs = [], []
        self.lmpc_prediction, self.mpc_cbf_prediction = [], []

    # ---- lifecycle -----------------------------------------------------

    def set_zero_noise(self):
        self.zero_noise_flag = True

    def set_timestep(self, dt):
        self.timestep = dt

    def set_state_curvilinear(self, xcurv):
        self.xcurv = np.asarray(xcurv, dtype=np.float64)

    def set_state_global(self, xglob):
        self.xglob = np.asarray(xglob, dtype=np.float64)

    def set_track(self, track):
        if track.lap_length.device != self.device or track.lap_length.dtype != self.dtype:
            raise ValueError(f"vehicle {self.name!r} is {self.dtype} on {self.device}; the track "
                             f"is {track.lap_length.dtype} on {track.lap_length.device}")
        self.track = track
        self.lap_length = float(track.lap_length)
        self.lap_width = float(track.width)

    def set_ctrl_policy(self, ctrl_policy):
        self.ctrl_policy = ctrl_policy
        self.ctrl_policy.agent_name = self.name

    def start_logging(self):
        self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], []
        self.lap_xcurvs.append(self.xcurv)
        self.lap_xglobs.append(self.xglob)

    def _tensor(self, a):
        """A host array as a contiguous tensor on the track's device."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype, device=self.device)

    # ---- stepping ------------------------------------------------------

    def calc_ctrl_input(self):
        self.ctrl_policy.set_state(self.xcurv, self.xglob)
        self.ctrl_policy.calc_input()
        self.u = self.ctrl_policy.get_input()

    def forward_dynamics(self, realtime_flag=False):
        raise NotImplementedError

    def forward_one_step(self, realtime_flag=False):
        if self.no_dynamics:
            self.forward_dynamics()
            self.update_memory()
        elif not realtime_flag:
            self.calc_ctrl_input()
            self.forward_dynamics(realtime_flag)
            self.ctrl_policy.set_state(self.xcurv, self.xglob)
            self.update_memory()
        else:
            self.forward_dynamics(realtime_flag)

    def update_memory(self):
        """Lap bookkeeping: on lap completion wrap s, close the lap lists
        and seed the next lap."""
        xcurv = np.array(self.xcurv, copy=True)
        self.xglob_log.append(np.array(self.xglob, copy=True))
        self.xcurv_log.append(np.array(self.xcurv, copy=True))
        if xcurv[4] > self.lap_length:
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(xcurv)
            self.lap_inputs.append(np.array(self.u, copy=True))
            self.xglobs.append(self.lap_xglobs)
            self.times.append(self.lap_times)
            self.xcurvs.append(self.lap_xcurvs)
            self.inputs.append(self.lap_inputs)
            self.xcurv = np.array(self.xcurv, copy=True)
            self.xcurv[4] -= self.lap_length
            self.laps += 1
            self.lap_xglobs, self.lap_xcurvs, self.lap_inputs, self.lap_times = [], [], [], []
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(np.array(self.xcurv, copy=True))
        else:
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(xcurv)
            self.lap_inputs.append(np.array(self.u, copy=True))


class DynamicBicycleModel(ModelBase):
    """Dynamic bicycle vehicle (vehicles.py:139-176): each step is one
    control period through :func:`dynamics.propagate` (one K1 launch on the
    card), then, unless ``set_zero_noise`` was called, process noise drawn
    from a ``torch.Generator`` on the device seeded by ``seed``."""

    def __init__(self, name=None, param=None, system_param=None, seed: int = 0, *,
                 device="cuda", dtype=torch.float64):
        super().__init__(name=name, param=param, device=device, dtype=dtype,
                         system_param=system_param or SystemParam.default(device=device,
                                                                          dtype=dtype))
        self.dynamics_param = dynamics.BicycleParams.default(device=self.device, dtype=dtype)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def __getstate__(self):  # a torch.Generator does not pickle; its state does
        state = self.__dict__.copy()
        state["_gen"] = state["_gen"].get_state()
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        gen = torch.Generator(device=self.device)
        gen.set_state(state["_gen"])
        self._gen = gen

    def forward_dynamics(self, realtime_flag=False):
        if self.u is None and realtime_flag:
            self.time += self.timestep
            return
        u = self.u if self.u is not None else np.zeros(U_DIM)
        xg, xc = dynamics.propagate(
            self.track, self.dynamics_param, self._tensor(self.xglob)[None],
            self._tensor(self.xcurv)[None], self._tensor(u)[None], control_dt=self.timestep)
        if not self.zero_noise_flag:
            xc = dynamics.process_noise(self._gen, xc)
        self.xcurv = xc[0].cpu().numpy().astype(np.float64)
        self.xglob = xg[0].cpu().numpy().astype(np.float64)
        self.time += self.timestep

    def get_trajectory_nsteps(self, time, timestep, n):
        """Constant-velocity ``n``-step forecast: (xcurv_nsteps (X_DIM, n),
        xglob_nsteps (X_DIM, n))."""
        xc, xg = dynamics.const_velocity_prediction(
            self.track, self._tensor(self.xcurv), self._tensor(self.xglob), timestep, n)
        return xc.cpu().numpy().T.astype(np.float64), xg.cpu().numpy().T.astype(np.float64)


class NoDynamicsModel(ModelBase):
    """Prescribed-motion obstacle: polynomial s(t), ey(t) (vehicles.py:179-226)."""

    def __init__(self, name=None, param=None, *, device="cuda", dtype=torch.float64):
        super().__init__(name=name, param=param, device=device, dtype=dtype)
        self.no_dynamics = True
        self.s_coef = None
        self.ey_coef = None

    def set_state_curvilinear_func(self, s_coef, ey_coef):
        """Coefficients in ``np.polyval`` order (highest degree first):
        e.g. s(t) = 0.7 t + 5.5 -> s_coef = [0.7, 5.5]."""
        self.s_coef = np.asarray(s_coef, dtype=np.float64)
        self.ey_coef = np.asarray(ey_coef, dtype=np.float64)
        self.xcurv, self.xglob = self.get_estimation(0.0)

    def get_estimation(self, t0):
        s = float(np.polyval(self.s_coef, t0))
        ey = float(np.polyval(self.ey_coef, t0))
        vs = float(np.polyval(np.polyder(self.s_coef), t0)) if len(self.s_coef) > 1 else 0.0
        vey = float(np.polyval(np.polyder(self.ey_coef), t0)) if len(self.ey_coef) > 1 else 0.0
        xcurv = np.array([vs, vey, 0.0, 0.0, s, ey])
        xglob = track_ops.frenet_to_global_state(self.track, self._tensor(xcurv))
        return xcurv, xglob.cpu().numpy().astype(np.float64)

    def get_trajectory_nsteps(self, t0, delta_t, n):
        """The polynomials on the host, then one batched Frenet-to-global
        conversion for the whole horizon."""
        ts = self.time + delta_t * np.arange(n)
        s = np.polyval(self.s_coef, ts)
        ey = np.polyval(self.ey_coef, ts)
        zeros = np.zeros(n)
        vs = np.polyval(np.polyder(self.s_coef), ts) if len(self.s_coef) > 1 else zeros
        vey = np.polyval(np.polyder(self.ey_coef), ts) if len(self.ey_coef) > 1 else zeros
        xcurv_nsteps = np.stack([vs, vey, zeros, zeros, s, ey], axis=1)  # (n, X_DIM)
        xglob_nsteps = track_ops.frenet_to_global_state(self.track, self._tensor(xcurv_nsteps))
        return xcurv_nsteps.T, xglob_nsteps.cpu().numpy().T.astype(np.float64)

    def forward_dynamics(self, realtime_flag=False):
        self.time += self.timestep
        self.xcurv, self.xglob = self.get_estimation(self.time)
