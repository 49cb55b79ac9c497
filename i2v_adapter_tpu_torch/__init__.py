"""PyTorch/CUDA port of the I2V-Adapter image-to-video framework.

Mirrors the module layout of the JAX package beside it; attention and, with
``conv_impl='pallas'``, the resnets' norm + SiLU + conv stages run through
hand-written CUDA kernels (``csrc/``) on the GPU.
"""

__version__ = "0.1.0"
