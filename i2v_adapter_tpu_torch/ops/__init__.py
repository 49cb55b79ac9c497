"""Ops of the port: attention (plain + CUDA kernels) and the prior's blur."""
