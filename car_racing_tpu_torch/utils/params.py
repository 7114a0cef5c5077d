"""Controller parameters and vehicle limits as frozen dataclasses of tensors
(car_racing_tpu/utils/params.py:19-186)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve


def load_lti(data_dir: str = "data", *, device="cuda", dtype=torch.float64):
    """Identified LTI (A, B) from ``{data_dir}/sys/LTI/matrix_{A,B}.csv``."""
    dev = resolve(device)
    A = np.genfromtxt(f"{data_dir}/sys/LTI/matrix_A.csv", delimiter=",")
    B = np.genfromtxt(f"{data_dir}/sys/LTI/matrix_B.csv", delimiter=",")
    return (torch.as_tensor(A, dtype=dtype, device=dev),
            torch.as_tensor(B, dtype=dtype, device=dev))


def _t(x, dev, dtype):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=dev)


@dataclasses.dataclass(frozen=True)
class SystemParam:
    """Actuation/state limits."""

    delta_max: torch.Tensor
    a_max: torch.Tensor
    v_max: torch.Tensor
    v_min: torch.Tensor

    @staticmethod
    def default(*, device="cuda", dtype=torch.float64) -> "SystemParam":
        dev = resolve(device)
        return SystemParam(*(_t(v, dev, dtype) for v in (0.5, 1.0, 10.0, 0.0)))


@dataclasses.dataclass(frozen=True)
class CarParam:
    """Vehicle geometry."""

    length: torch.Tensor
    width: torch.Tensor

    @staticmethod
    def default(*, device="cuda", dtype=torch.float64) -> "CarParam":
        dev = resolve(device)
        return CarParam(_t(0.4, dev, dtype), _t(0.2, dev, dtype))


@dataclasses.dataclass(frozen=True)
class MPCParam:
    """MPC-LTI tracking parameters."""

    A: torch.Tensor
    B: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    vt: torch.Tensor
    eyt: torch.Tensor
    num_horizon: int = 10

    @staticmethod
    def default(vt=0.6, eyt=0.0, data_dir="data", *, device="cuda",
                dtype=torch.float64) -> "MPCParam":
        dev = resolve(device)
        A, B = load_lti(data_dir, device=dev, dtype=dtype)
        return MPCParam(
            A=A,
            B=B,
            Q=_t(np.diag([10.0, 0.0, 0.0, 4.0, 0.0, 40.0]), dev, dtype),
            R=_t(np.diag([0.1, 0.1]), dev, dtype),
            vt=_t(vt, dev, dtype),
            eyt=_t(eyt, dev, dtype),
        )


@dataclasses.dataclass(frozen=True)
class LMPCParam:
    """LMPC parameters (car_racing_tpu/utils/params.py:167-186): ``num_ss_points``
    safe-set points in all, taken from the last ``num_ss_iter`` laps."""

    Q: torch.Tensor
    R: torch.Tensor
    Qslack: torch.Tensor
    dR: torch.Tensor
    num_ss_points: int = 44
    num_ss_iter: int = 2
    num_horizon: int = 12
    shift: int = 0

    @staticmethod
    def default(*, device="cuda", dtype=torch.float64) -> "LMPCParam":
        dev = resolve(device)
        return LMPCParam(
            Q=_t(np.zeros((6, 6)), dev, dtype),
            R=_t(np.diag([1.0, 0.25]), dev, dtype),
            Qslack=_t(5 * np.diag([10, 0, 0, 1, 10, 0]), dev, dtype),
            dR=_t(5 * np.diag([0.8, 0.0]), dev, dtype),
        )


@dataclasses.dataclass(frozen=True)
class ILQRParam:
    """iLQR parameters (car_racing_tpu/utils/params.py:86-108): LTI model,
    stage costs, at most ``max_iter`` Levenberg iterations over a horizon of
    ``num_horizon`` stages."""

    A: torch.Tensor
    B: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    vt: torch.Tensor
    eyt: torch.Tensor
    max_iter: int = 150
    num_horizon: int = 50

    @staticmethod
    def default(vt=0.6, eyt=0.0, data_dir="data", *, device="cuda",
                dtype=torch.float64) -> "ILQRParam":
        dev = resolve(device)
        A, B = load_lti(data_dir, device=dev, dtype=dtype)
        return ILQRParam(
            A=A,
            B=B,
            Q=_t(np.diag([10.0, 0.0, 0.0, 4.0, 0.0, 40.0]), dev, dtype),
            R=_t(np.diag([0.1, 0.1]), dev, dtype),
            vt=_t(vt, dev, dtype),
            eyt=_t(eyt, dev, dtype),
        )


@dataclasses.dataclass(frozen=True)
class MPCCBFParam:
    """MPC-CBF parameters (car_racing_tpu/utils/params.py:139-162): the
    MPC-LTI costs plus the barrier decay rate ``alpha``."""

    A: torch.Tensor
    B: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    vt: torch.Tensor
    eyt: torch.Tensor
    alpha: torch.Tensor
    num_horizon: int = 10

    @staticmethod
    def default(vt=0.6, eyt=0.0, alpha=0.8, data_dir="data", *, device="cuda",
                dtype=torch.float64) -> "MPCCBFParam":
        dev = resolve(device)
        A, B = load_lti(data_dir, device=dev, dtype=dtype)
        return MPCCBFParam(
            A=A,
            B=B,
            Q=_t(np.diag([10.0, 0.0, 0.0, 4.0, 0.0, 40.0]), dev, dtype),
            R=_t(np.diag([0.1, 0.1]), dev, dtype),
            vt=_t(vt, dev, dtype),
            eyt=_t(eyt, dev, dtype),
            alpha=_t(alpha, dev, dtype),
        )
