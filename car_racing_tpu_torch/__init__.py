"""PyTorch/CUDA port of car_racing_tpu for NVIDIA Hopper (H100).

The JAX package ``car_racing_tpu`` stays the reference; this package mirrors
its layout (``utils/``, ``ops/``, ``models/``, ``racing/``, ``planning/``)
and replaces its Pallas TPU kernels with CUDA C++ kernels for ``sm_90a``
(``csrc/``, bound in ``kernels/``).  It imports neither ``jax`` nor
``car_racing_tpu``.

Entry points that create tensors take ``device`` and ``dtype``; ``device``
defaults to ``"cuda"`` and raises where no GPU is present.  Functions that
take tensors run on the device of their inputs: the kernel for CUDA tensors,
its plain PyTorch version for CPU tensors.
"""
