"""Chunked linear attention with decay (``rwkv``/``ssd``): CUDA kernel."""
