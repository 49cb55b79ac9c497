"""Ops of the port: attention, the fused norm + SiLU + 3x3 conv and the int8
matmul (plain versions + CUDA kernels), GroupNorm statistics, the prior's blur."""
