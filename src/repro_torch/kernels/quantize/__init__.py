"""Block-wise int8/int4 quantization of the fusion messages: CUDA kernels,
their plain PyTorch versions and the dispatch between them."""
