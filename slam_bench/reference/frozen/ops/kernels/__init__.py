"""The plain versions of the port's five CUDA kernels, frozen."""
