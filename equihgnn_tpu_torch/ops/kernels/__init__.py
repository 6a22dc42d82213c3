"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. `build.py` compiles `csrc/` with nvcc at first use."""
