"""GQA decode attention against a KV cache (flash-decode): the CUDA kernel,
its plain PyTorch version and the dispatch between them."""
