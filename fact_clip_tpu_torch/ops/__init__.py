"""Operations of the port: the hand-written Hopper kernels, each beside its
plain PyTorch version, and the segment operations of the TDU blocks.

A kernel wrapper runs its plain version when handed CPU tensors and launches
its CUDA kernel (or raises) when handed CUDA tensors; it never falls back.
"""
