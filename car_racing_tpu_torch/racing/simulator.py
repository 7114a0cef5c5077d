"""Offboard batch simulator (car_racing_tpu/racing/simulator.py).

A multi-vehicle lockstep loop with lap detection and a ``one_lap`` early
stop.  The loop only orchestrates on the host; each vehicle's step runs on
its track's device.
"""

from __future__ import annotations

import pickle

import numpy as np


class CarRacingSim:
    def __init__(self):
        self.track = None
        self.vehicles = {}
        self.opti_traj_xglob = None
        self.timestep = None

    def set_timestep(self, dt):
        self.timestep = dt

    def set_track(self, track):
        self.track = track

    def set_opti_traj(self, opti_traj_xglob):
        self.opti_traj_xglob = opti_traj_xglob

    def add_vehicle(self, vehicle):
        self.vehicles[vehicle.name] = vehicle
        vehicle.set_track(self.track)
        vehicle.set_timestep(self.timestep)

    def sim(self, sim_time=50.0, one_lap=False, one_lap_name=None):
        if one_lap:
            current_lap = self.vehicles[one_lap_name].laps
        for _ in range(int(sim_time / self.timestep)):
            for name in self.vehicles:
                self.vehicles[name].forward_one_step(self.vehicles[name].realtime_flag)
            if one_lap and self.vehicles[one_lap_name].laps > current_lap:
                break

    # ---- persistence: the drivers pickle the whole simulator ------------

    def save(self, path):
        with open(path, "wb") as fh:
            pickle.dump(self, fh, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(path):
        """Unpickle a simulator that :meth:`save` wrote (unpickling runs
        code: load only files this program wrote)."""
        with open(path, "rb") as fh:
            return pickle.load(fh)

    # ---- trajectory extraction -----------------------------------------

    def full_trajectory(self, name, kind="xcurv"):
        """All completed laps and the running lap as one array."""
        veh = self.vehicles[name]
        rows = []
        src_laps = veh.xcurvs if kind == "xcurv" else veh.xglobs
        src_lap = veh.lap_xcurvs if kind == "xcurv" else veh.lap_xglobs
        for lap in src_laps:
            rows.extend(lap[:-1])
        rows.extend(src_lap)
        return np.asarray(rows)
