# Hand-written Hopper kernels (CUDA C++ under csrc/, built by build.py) and
# their plain PyTorch versions.
