"""Hand-written Hopper kernels of the port, one package per TPU kernel:
`kernel.py` builds and launches the CUDA kernel, `ref.py` is its plain
PyTorch version, `ops.py` the wrapper that picks between them."""
