"""The RWKV-6 WKV recurrence in chunks of 32 steps: the CUDA kernel, its
plain PyTorch versions (chunked and step by step) and the dispatch."""
