"""Hand-written CUDA kernels of the linker, and the nvcc build route."""
