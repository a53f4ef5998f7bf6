"""PyTorch + CUDA port of the reproduction in `repro`.

The port mirrors `repro`'s layout (`core/…`, `kernels/<name>/{kernel,ref,
ops}.py`) and imports neither `jax` nor `repro`: where it needs a
numpy-only module of `repro`, it keeps its own copy.  Everything is
float32, and state is plain tensors with an explicit leading batch axis
(configurations) in place of `vmap`.  Entry points take `device=`, which
defaults to ``"cuda"``; the CPU is used only when the caller asks for it.
"""
