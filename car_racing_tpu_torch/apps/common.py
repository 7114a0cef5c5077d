"""Shared wiring for the port's drivers (car_racing_tpu/apps/common.py).

Saved simulators go under ``data/simulator/`` with a ``torch_`` prefix, so
the two packages' drivers never overwrite each other's files.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import track as track_ops
from ..racing import simulator, vehicles
from ..utils.constants import X_DIM


def refuse_plotting(args):
    """Raise if ``--plotting`` or ``--animation`` was asked for: the port
    has no ``racing/plotting`` yet (it needs matplotlib)."""
    asked = [flag for flag in ("plotting", "animation") if args.get(flag)]
    if asked:
        raise NotImplementedError(
            f"--{' and --'.join(asked)}: plotting is not ported to car_racing_tpu_torch yet; "
            "run without these flags")


def sim_path(name: str) -> str:
    return f"data/simulator/torch_{name}.obj"


def build_track(track_layout: str, width: float = 0.8, *, device="cuda"):
    return track_ops.load_track(track_layout, width=width, device=device)


def build_ego(track, timestep=0.1, zero_noise=True, seed=0):
    """The ego at rest at the start line, on the track's device."""
    ego = vehicles.DynamicBicycleModel(name="ego", seed=seed, device=track.lap_length.device,
                                       dtype=track.lap_length.dtype)
    if zero_noise:
        ego.set_zero_noise()
    ego.set_timestep(timestep)
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    ego.set_track(track)
    return ego


def build_sim(track, timestep=0.1):
    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    return sim


def attach_policy(ego, sim, policy, timestep=0.1):
    policy.set_timestep(timestep)
    policy.set_track(sim.track)
    policy.set_racing_sim(sim)
    ego.set_ctrl_policy(policy)
    return policy


def save_sim(sim, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sim.save(path)


def load_sim(path):
    return simulator.CarRacingSim.load(path)


def finish():
    """Print the solve-latency table (host wall time per solve, the result
    back on the host)."""
    from ..utils.profiling import GLOBAL_TIMER

    report = GLOBAL_TIMER.report()
    if report:
        print("solver latency (host wall-clock, result on the host):")
        print(report)
