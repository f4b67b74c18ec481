"""Tensor ops of the port: plain PyTorch, plus the hand-written CUDA
kernels' wrappers (``paged_attention``)."""
