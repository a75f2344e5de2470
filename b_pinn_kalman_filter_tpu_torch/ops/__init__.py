"""Hand-written Hopper kernels, each beside its plain PyTorch version.

* ``conv3x3``   — K1, stride-1 SAME 3x3 conv + bias (``csrc/conv3x3.cu``).
* ``groupnorm`` — K2, fused GroupNorm + SiLU/ELU (``csrc/groupnorm.cu``).

Importing these modules builds nothing: the CUDA sources are compiled by
``_build`` at the first launch on a CUDA tensor.
"""
