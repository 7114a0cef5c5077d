"""K3: batched SPD solve with several right-hand sides, ``A X = Brhs``
(``csrc/cholesky_solve.cu``, the kernel of K2 with r right-hand sides).

Replaces ``cholesky_solve_multi_batched`` of
car_racing_tpu/ops/pallas_kernels.py:215 (``pl.pallas_call`` at :202,
dispatched by ``solve_multi_batched`` at :243).  :func:`solve_multi`
launches the kernel for CUDA tensors and runs :func:`plain` for CPU
tensors; ``launches`` counts the kernel launches.  The launch plan is
:func:`.cholesky.plan`.
"""

from __future__ import annotations

import torch

from . import cholesky

launches = 0


def plain(A: torch.Tensor, Brhs: torch.Tensor) -> torch.Tensor:
    """What the JAX package runs off the TPU (``jnp.linalg.cholesky`` +
    ``cho_solve``): a problem whose matrix is not positive definite comes
    back as NaN, as ``jnp.linalg.cholesky`` makes it."""
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(Brhs, L)
    return torch.where((info == 0)[:, None, None], X, torch.nan)


def solve_multi(A: torch.Tensor, Brhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] X[i] = Brhs[i]`` for ``A (B, n, n)`` SPD and
    ``Brhs (B, n, r)``; returns ``X (B, n, r)``."""
    global launches
    if A.device.type == "cpu":
        return plain(A, Brhs)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    if (A.dim() != 3 or A.shape[1] != A.shape[2] or Brhs.dim() != 3
            or tuple(Brhs.shape[:2]) != tuple(A.shape[:2])):
        raise ValueError(
            f"K3 takes A (B, n, n) and Brhs (B, n, r), got {tuple(A.shape)}, {tuple(Brhs.shape)}")
    X = cholesky.launch(A, Brhs, Brhs.shape[2], "K3")
    if A.shape[0]:
        launches += 1
    return X
