#!/usr/bin/env python3
"""How far the port's racing-game lap wanders on the GPU when its start is
nudged by a few units in the last place.

    python -m tools.racing_game_card_spread [--ulps 6] [--fleet-ulps 12] [--n-steps 250]
                                            [--out build/racing_game_card_spread.json]
                                            [--device cuda]

Run from the repository root on a machine with a CUDA GPU.  Runs the port's
``rollout_racing_game`` in float64 on the card (every step through K1,
every overtake step's corridor QPs through K2) from the l_shape golden's
start (``data/bench/lmpc_seed_l_shape.npz``, the traffic of
``chip_smoke.RG_LAPS``), its initial vx nudged by k units in the last
place:

- ``single``: one call a lap, k = -ulps..ulps (k = 0 is ``chip_smoke.py``'s
  ``racing_game`` lap);
- ``fleet``: k = -fleet_ulps..fleet_ulps as the lanes of one
  ``rollout_racing_game_batch`` call (a lane of a batch rounds otherwise
  than a single-lane run, so it is one more draw).

Each lap is summarised as ``tools/racing_game_spread.py`` summarises the JAX
laps: lap steps, overtake steps, least superellipse barrier over the cars
and largest |ey|; and beside them where the least barrier is reached (the
row, the car, |ds| and |dey|), how closely it passes each car side by side
(|ds| < 0.4), the steps whose solves stopped at their iteration cap, and
which of the ten steps before the closest row overtook or capped.  Prints one JSON line a lap and the spreads last, and
writes them to ``--out`` with the unnudged lap's rows and inputs
(``unnudged``), which ``python -m tools.racing_game_spread --replay-card``
replays in JAX.  It takes about 6 minutes on an H100.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from chip_smoke import RG_LAPS, least_barrier


def nudge(x, k):
    """``x`` moved by ``k`` units in the last place of its dtype."""
    x = np.asarray(x).copy()
    for _ in range(abs(k)):
        x = np.nextafter(x, np.inf if k > 0 else -np.inf)
    return x


def closest(rows, s_coef, ey_coef, L):
    """Where the least barrier is reached: the row, the car, and |ds|, |dey|
    there (the formula of ``chip_smoke.least_barrier``)."""
    t = np.arange(len(rows)) * 0.1
    best = None
    for car, (cs, ce) in enumerate(zip(s_coef, ey_coef)):
        ds = np.abs(np.mod(rows[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(rows[:, 5] - np.polyval(ce, t))
        bar = (ds / 0.4) ** 6 + (dey / 0.2) ** 6
        r = int(np.argmin(bar))
        if best is None or bar[r] < best["barrier"]:
            best = {"barrier": float(bar[r]), "row": r, "car": car, "ds": float(ds[r]),
                    "dey": float(dey[r])}
    return best


def alongside(rows, s_coef, ey_coef, L):
    """Per car, how many rows run side by side with it (|ds| under the
    footprint's half-length, 0.4) and the least |dey| over them (None where
    none does)."""
    t = np.arange(len(rows)) * 0.1
    out = []
    for car, (cs, ce) in enumerate(zip(s_coef, ey_coef)):
        ds = np.abs(np.mod(rows[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(rows[:, 5] - np.polyval(ce, t))[ds < 0.4]
        out.append({"car": car, "rows": int(dey.size),
                    "min_dey": float(dey.min()) if dey.size else None})
    return out


def summarise(k, xc, ot, lap_steps, capped, s_coef, ey_coef, L):
    """A lap's summary; ``capped[t]``: whether a solve of step t stopped at
    its iteration cap.  ``before_closest``: the overtake and capped steps
    among the ten steps that lead to the closest row."""
    rows = xc[: lap_steps + 1]
    near = closest(rows, s_coef, ey_coef, L)
    lead = range(max(near["row"] - 10, 0), near["row"])
    return {"k": k, "lap_steps": lap_steps, "overtake_steps": int(ot[:lap_steps].sum()),
            "least_barrier": least_barrier(rows, s_coef, ey_coef, L),
            "max_abs_ey": float(np.abs(rows[:, 5]).max()),
            "finite": bool(np.isfinite(rows).all()),
            "capped_steps": int(np.sum(capped[:lap_steps])), "closest": near,
            "alongside": alongside(rows, s_coef, ey_coef, L),
            "before_closest": {"overtake_steps": [t for t in lead if ot[t]],
                               "capped_steps": [t for t in lead if capped[t]]}}


def spread_of(laps):
    get = lambda key: [lap[key] for lap in laps]
    return {"n_laps": len(laps),
            "lap_steps_range": [min(get("lap_steps")), max(get("lap_steps"))],
            "overtake_steps_range": [min(get("overtake_steps")), max(get("overtake_steps"))],
            "least_barrier_min": min(get("least_barrier")),
            "least_barrier_sorted": sorted(get("least_barrier")),
            "max_abs_ey_max": max(get("max_abs_ey"))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ulps", type=int, default=6, help="single-lane laps for k = -ulps..ulps")
    ap.add_argument("--fleet-ulps", type=int, default=12,
                    help="one batch of lanes for k = -fleet_ulps..fleet_ulps")
    ap.add_argument("--n-steps", type=int, default=250)
    ap.add_argument("--device", default="cuda", help="cpu only for a rehearsal at few steps")
    ap.add_argument("--out", default="build/racing_game_card_spread.json")
    a = ap.parse_args()

    import torch

    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import fixtures, params

    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("racing_game_card_spread: no CUDA device")
    kw = dict(device=a.device, dtype=torch.float64)
    layout = "l_shape"
    _, s_coef, ey_coef = RG_LAPS[layout]
    sd = fixtures.load_lmpc_seed(layout, **kw)
    tr = track.load_track(layout, width=1.0, **kw)
    heads = (tr, dynamics.BicycleParams.default(**kw), params.LMPCParam.default(**kw),
             dataclasses.replace(params.RacingGameParam.default(alpha=0.8, **kw),
                                 corridor_hold=0.15),
             params.SystemParam.default(**kw))
    cols = (sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"], sd["u2"], sd["valid1"],
            sd["valid2"], sd["counter"])
    tail = (sd["lin_points0"], sd["lin_input0"], torch.as_tensor(s_coef, **kw),
            torch.as_tensor(ey_coef, **kw),
            torch.as_tensor(np.genfromtxt(f"data/optimal_traj/xcurv_{layout}.csv",
                                          delimiter=","), **kw))
    L = float(tr.lap_length)
    x0 = sd["xcurv0"].cpu().numpy()

    def start(k):
        x = x0.copy()
        x[0] = nudge(x[0], k)
        return x

    out = {"layout": layout, "dtype": "f64", "n_steps": a.n_steps,
           "device": torch.cuda.get_device_name(0) if a.device == "cuda" else a.device}
    laps = []
    t0 = time.perf_counter()
    for k in range(-a.ulps, a.ulps + 1):
        solves = []
        xc, us, ot, ls = fused.rollout_racing_game(
            *heads, torch.as_tensor(start(k), **kw), sd["xglob0"], *cols, *tail,
            n_steps=a.n_steps, solves=solves)
        capped = [bool(q.capped[0]) for q in solves]
        if k == 0:  # the unnudged lap, for tools.racing_game_spread --replay-card
            out["unnudged"] = {"xcurv": xc.cpu().tolist(), "u": us.cpu().tolist(),
                               "lap_steps": int(ls)}
        laps.append(summarise(k, xc.cpu().numpy(), ot.cpu().numpy(), int(ls), capped, s_coef,
                              ey_coef, L))
        print(json.dumps({"run": "single", **laps[-1]}), flush=True)
    out["single"] = {"vx_ulps": a.ulps, "laps": laps, **spread_of(laps),
                     "seconds": time.perf_counter() - t0}

    ks = list(range(-a.fleet_ulps, a.fleet_ulps + 1))
    t0 = time.perf_counter()
    xc0 = torch.as_tensor(np.stack([start(k) for k in ks]), **kw)
    xg0 = sd["xglob0"].expand(len(ks), 6).contiguous()
    solves = []
    xc, _, ot, ls = fused.rollout_racing_game_batch(*heads, xc0, xg0, *cols, *tail,
                                                    n_steps=a.n_steps, solves=solves)
    xc, ot, ls = xc.cpu().numpy(), ot.cpu().numpy(), ls.cpu().numpy()
    capped = torch.stack([q.capped for q in solves], dim=1).cpu().numpy()
    lanes = [summarise(k, xc[b], ot[b], int(ls[b]), capped[b], s_coef, ey_coef, L)
             for b, k in enumerate(ks)]
    for lane in lanes:
        print(json.dumps({"run": "fleet", **lane}), flush=True)
    out["fleet"] = {"vx_ulps": a.fleet_ulps, "laps": lanes, **spread_of(lanes),
                    "seconds": time.perf_counter() - t0}

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f)
        f.write("\n")
    print(json.dumps({run: {k: v for k, v in out[run].items() if k != "laps"}
                      for run in ("single", "fleet")}))


if __name__ == "__main__":
    main()
