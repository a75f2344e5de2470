"""b_pinn_kalman_filter_tpu_torch — the PyTorch/CUDA port of
``b_pinn_kalman_filter_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference: each module here keeps the name
of its JAX counterpart, and the tests hold the two against each other.
What is ported so far is the serving path and the training loop of the
flagship config ``vp/cifar10_ddpmpp_continuous``, the training of
``vp/nc_ddpmpp`` by the discrete DDPM loss, the inverse suite and, at
``pinn/pinn_pde`` (FlowNet) and ``pinn/pinn_pde_lfn`` (LiteFlowNet), PINN
and B-PINN training, the ``ukf`` path and the simulator; ``python -m
b_pinn_kalman_filter_tpu_torch`` is the command line (``__main__.py``):

* ``configs``  — attribute-dict copies of the JAX configs (same keys).
* ``core``     — the SDEs, the samplers, the continuous DSM loss and the
                 discrete SMLD and DDPM losses, the optimizer and the
                 train and eval steps.
* ``ops``      — hand-written Hopper kernels (3x3 conv, GroupNorm+SiLU,
                 FlowNet cost volume, Navier–Stokes step), each with its
                 plain PyTorch version beside it; the grid sampler.
* ``models``   — the DDPM U-Net, FlowNet, LiteFlowNet and PressureNet,
                 their layers, the
                 EMA helper, and the loaders of flax params and train
                 states (``convert``).
* ``pinn``     — the PINN forward, its residual and training phases, and
                 the B-PINN posterior, draws, KL terms and training.
* ``kalman``   — the square-root UKF, its NS dynamics and measurement,
                 ``ukf_lib.run``, and the simulators (``simulator``).
* ``data``     — data scalers, the CIFAR-10 loader with its synthetic
                 stand-in, and the synthetic NS rollout.
* ``train``    — ``run_lib.train`` and ``run_lib.sample``, the train state
                 and its checkpoints.
* ``utils``    — image grids written as PNG files.

Layout is NHWC with HWIO conv kernels, as in the JAX package.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
