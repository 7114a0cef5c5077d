"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

- :mod:`.propagate` (K1): one control period of the bicycle integrator,
  two lanes per vehicle (replaces ``propagate_fused`` of
  car_racing_tpu/ops/pallas_kernels.py).
- :mod:`.cholesky` (K2): batched SPD solve, one warp or one block of
  threads per problem, in shared or device memory by :func:`.cholesky.plan`
  (replaces ``cholesky_solve_batched`` of the same file).
- :mod:`.cholesky_multi` (K3): the same kernel with several right-hand
  sides (replaces ``cholesky_solve_multi_batched``).

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, counting the launches in a module-level integer
``launches``.  :mod:`.build` compiles ``csrc/*.cu`` with nvcc at first use.
"""
