"""b_pinn_kalman_filter_tpu_torch — the PyTorch/CUDA port of
``b_pinn_kalman_filter_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: each module here keeps the name
of its JAX counterpart, and the tests hold the two against each other.
What is ported so far is the serving path of the flagship config
``vp/cifar10_ddpmpp_continuous`` and the ``ukf`` path of ``pinn/pinn_pde``:

* ``configs``  — attribute-dict copies of the JAX configs (same keys).
* ``core``     — the SDEs and the predictor–corrector sampler.
* ``ops``      — hand-written Hopper kernels (3x3 conv, GroupNorm+SiLU,
                 FlowNet cost volume, Navier–Stokes step), each with its
                 plain PyTorch version beside it; the grid sampler.
* ``models``   — the DDPM U-Net, FlowNet and PressureNet, their layers, and
                 the loaders of flax params (``convert``).
* ``pinn``     — the PINN forward and the B-PINN posterior and draws.
* ``kalman``   — the square-root UKF, its NS dynamics and measurement, and
                 ``ukf_lib.run``.
* ``data``     — data scalers and the synthetic NS rollout.
* ``train``    — ``run_lib.sample``.

Layout is NHWC with HWIO conv kernels, as in the JAX package.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
