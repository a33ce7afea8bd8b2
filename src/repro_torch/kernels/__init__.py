"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Importing this package builds nothing: a kernel is compiled by
``kernels._build`` at its first launch on a CUDA tensor."""
