"""Hand-written Hopper kernels of the port, one package per TPU kernel:
`kernel.py` checks its inputs and launches the CUDA kernel (built by
`nvcc.py` from `csrc/`), `ref.py` is its plain PyTorch version, `ops.py`
the wrapper that picks between them."""
