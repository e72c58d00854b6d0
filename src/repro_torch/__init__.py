"""PyTorch + CUDA port of the co-rank merge library (``repro``'s twin).

Modules mirror ``src/repro/`` one file to one file.  Plain tensor code is
PyTorch; the two Pallas TPU kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built with ``nvcc`` at the first CUDA call.  Importing
the package compiles nothing and needs no GPU.
"""
