"""Tracking-controller driver (car_racing_tpu/apps/control_test.py).

    python -m car_racing_tpu_torch.apps.control_test --ctrl-policy mpc-lti \
        --track-layout l_shape --simulation [--zero-noise] [--device cuda]

With ``--simulation`` it drives the ego for 90 s of simulated time on the
track and saves the simulator to ``data/simulator/torch_<policy>_<layout>.obj``;
without it, it loads that file.  ``--plotting`` and ``--animation`` raise:
plotting is not ported yet.
"""

import argparse

import torch

from . import common
from ..racing import policies
from ..utils import params

SIM_TIME = 90.0


def tracking(args):
    """Run (or load) one tracking simulation; returns the simulator."""
    common.refuse_plotting(args)
    layout = args["track_layout"]
    name = f"{args['ctrl_policy']}_{layout}"
    if args["simulation"]:
        device = args.get("device", "cuda")
        kw = dict(device=device, dtype=torch.float64)
        track = common.build_track(layout, device=device)
        ego = common.build_ego(track, zero_noise=args.get("zero_noise", False))
        sim = common.build_sim(track)
        sim.add_vehicle(ego)
        if args["ctrl_policy"] == "pid":
            policy = policies.PIDTracking(vt=0.8)
        elif args["ctrl_policy"] == "mpc-lti":
            policy = policies.MPCTracking(params.MPCParam.default(vt=0.8, **kw),
                                          params.SystemParam.default(**kw))
        elif args["ctrl_policy"] == "lqr":
            policy = policies.LQRTracking(params.LQRParam.default(vt=0.8, **kw),
                                          params.SystemParam.default(**kw))
        else:
            raise ValueError(f"unknown ctrl policy {args['ctrl_policy']}")
        common.attach_policy(ego, sim, policy)
        sim.sim(sim_time=SIM_TIME)
        common.save_sim(sim, common.sim_path(name))
    else:
        sim = common.load_sim(common.sim_path(name))
    common.finish()
    return sim


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ctrl-policy", type=str, default="mpc-lti")
    parser.add_argument("--simulation", action="store_true")
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--animation", action="store_true")
    parser.add_argument("--zero-noise", action="store_true")
    parser.add_argument("--track-layout", type=str, default="l_shape")
    parser.add_argument("--device", type=str, default="cuda")
    tracking(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
