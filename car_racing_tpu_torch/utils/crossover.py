"""Dense-condensed against Riccati-KKT MPC-LTI solves, by horizon
(car_racing_tpu/utils/crossover.py).

Times one ``controllers.mpc_lti`` solve (f32, at most 30 interior-point
iterations, one state) through each Newton-step factorization:

- ``dense``: condense onto U and factor the (N*2)^2 barrier-augmented
  system each iteration;
- ``riccati``: the stage-structured sweep of ``ipm.solve_ocp_qp``, O(N)
  sequential stages each iteration;
- ``riccati_parallel``: the same sweep by associative scans, O(log N) depth.

Each solve is timed alone with CUDA events after a warm-up, from states
``[0.4, 0, 0, 0, 0.5, 0.1] + 0.05 N(0, 1)`` (numpy ``default_rng(0)``).
It runs on a CUDA device only:

    python -m car_racing_tpu_torch.utils.crossover [--out FILE]

It writes a file only when given one, never the TPU record
``CROSSOVER.json``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

HORIZONS = (10, 20, 50, 100, 200)
REPS = 10
KKTS = ("dense", "riccati", "riccati_parallel")


def measure(horizons=HORIZONS, reps=REPS, out_path=None, *, device="cuda"):
    """One row per horizon: each factorization's median and largest ms per
    solve over ``reps`` solves (``reps``: one count, or one per horizon),
    ``n_samples``, how many solves converged, whether every input was
    finite, and the mean IPM iterations.  Returns the rows."""
    from ..models import controllers
    from ..utils import params
    from ..utils.device import resolve

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"crossover times CUDA solves; got device {dev}")
    f32 = torch.float32
    kw = dict(device=dev, dtype=f32)
    sysp = params.SystemParam.default(**kw)
    base = params.MPCParam.default(vt=0.8, **kw)
    xt = controllers.target_state(0.8, 0.0, **kw)
    width = torch.tensor(0.8, **kw)
    if isinstance(reps, int):
        reps = [reps] * len(horizons)
    rng = np.random.default_rng(0)
    rows = []
    for N, n in zip(horizons, reps):
        p = params.MPCParam(A=base.A, B=base.B, Q=base.Q, R=base.R, vt=base.vt, eyt=base.eyt,
                            num_horizon=N)
        x0s = torch.as_tensor(np.array([0.4, 0, 0, 0, 0.5, 0.1])
                              + 0.05 * rng.standard_normal((n, 6)), **kw)
        row = {"N": N, "n_samples": n}
        for kkt in KKTS:

            def solve(x, solves=None):
                return controllers.mpc_lti(x, xt, p, sysp, width, kkt=kkt, solves=solves)

            solve(x0s[:1])  # warm-up
            ms, conv, finite, its = [], 0, True, []
            for i in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                solves = []
                start.record()
                u0 = solve(x0s[i:i + 1], solves)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                conv += int(solves[0].converged.sum())
                finite = finite and bool(u0.isfinite().all())
                its.append(int(solves[0].iterations[0]))
            row[f"{kkt}_ms"] = float(np.median(ms))
            row[f"{kkt}_max_ms"] = float(np.max(ms))
            row[f"{kkt}_converged"] = conv
            row[f"{kkt}_finite"] = finite
            row[f"{kkt}_iterations_mean"] = float(np.mean(its))
        row["speedup_riccati"] = row["dense_ms"] / row["riccati_ms"]
        row["speedup_parallel_vs_riccati"] = row["riccati_ms"] / row["riccati_parallel_ms"]
        rows.append(row)
        print(json.dumps({"crossover": row}), flush=True)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"device": torch.cuda.get_device_name(dev), "iters": 30, "rows": rows},
                      fh, indent=1)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", help="write the rows to this JSON file")
    a = ap.parse_args()
    measure(reps=a.reps, out_path=a.out)


if __name__ == "__main__":
    main()
