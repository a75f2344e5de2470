"""Hand-written Hopper kernels, each beside its plain PyTorch version, and
the plain ops around them.

* ``conv3x3``     — K1, stride-1 SAME 3x3 conv + bias (``csrc/conv3x3.cu``).
* ``groupnorm``   — K2, fused GroupNorm + SiLU/ELU (``csrc/groupnorm.cu``).
* ``correlation`` — K3, FlowNet cost volume (``csrc/correlation.cu``).
* ``ns_step``     — K4, one Navier–Stokes step (``csrc/ns_step.cu``).
* ``grid_sample`` — bilinear sampling as gather + lerp (no kernel).

Importing these modules builds nothing: the CUDA sources are compiled by
``_build`` at the first launch on a CUDA tensor.
"""
