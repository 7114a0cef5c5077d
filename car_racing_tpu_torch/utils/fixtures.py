"""The committed LMPC seed laps (``data/bench/lmpc_seed_{layout}.npz``).

Each file holds two laps of safe-set data (the PID lap and the MPC lap of
the reference's protocol, zero noise, recorded by the JAX package's
``car_racing_tpu/utils/bench_fixtures.py``) and the start of the LMPC lap
that follows them: ``ss1``/``ss2`` (P, 6) sentinel-padded safe sets,
``q1``/``q2`` (P,) their cost-to-go, ``u1``/``u2`` (P, 2) their inputs,
``valid1``/``valid2`` (P,) regression-row masks, ``counter`` (the append
offset into ``ss1``), ``lin_points0`` (N+1, 6), ``lin_input0`` (N, 2),
``xcurv0`` and ``xglob0``.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve

LAYOUTS = ("l_shape", "goggle", "m_shape", "ellipse")


def seed_path(layout: str, data_dir: str = "data") -> str:
    return f"{data_dir}/bench/lmpc_seed_{layout}.npz"


def load_lmpc_seed(layout: str, data_dir: str = "data", *, device="cuda",
                   dtype=torch.float64) -> dict:
    """The seed of ``layout`` as tensors on ``device``: float arrays in
    ``dtype``, the masks as bool, ``counter`` and ``pid_lap_steps`` as ints."""
    dev = resolve(device)
    out = {}
    with np.load(seed_path(layout, data_dir)) as seed:
        for name in seed.files:
            v = seed[name]
            if v.dtype == np.bool_:
                out[name] = torch.as_tensor(v, device=dev)
            elif np.issubdtype(v.dtype, np.integer):
                out[name] = int(v)
            else:
                out[name] = torch.as_tensor(np.array(v, np.float64), dtype=dtype, device=dev)
    return out
