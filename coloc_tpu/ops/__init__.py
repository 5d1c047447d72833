"""Compute ops: plain XLA implementations, plus the Hamming 2-NN Pallas
kernel (Triton route) that runs on the GPU (ops/hamming.py).

The backend alone chooses a path, replacing the reference's compile-time
#ifdef USE_CUDA backend split (CMakeLists.txt:9-11).
"""
