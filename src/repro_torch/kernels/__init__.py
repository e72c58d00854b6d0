"""Kernel layer of the port: CUDA merge kernels, their dispatch and oracles."""
