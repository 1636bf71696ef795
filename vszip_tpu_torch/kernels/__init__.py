"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each beside
its plain PyTorch version and a launch counter.  Importing a kernel module
builds nothing: the library is compiled with nvcc at the first launch."""
