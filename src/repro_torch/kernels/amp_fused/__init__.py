"""Fused AMP local-computation step (row layout): CUDA kernels, their plain
PyTorch versions and the dispatch between them."""
