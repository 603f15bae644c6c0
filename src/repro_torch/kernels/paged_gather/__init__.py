"""Paged KV-cache gather: CUDA kernel wrapper (``kernel``) and plain
torch version (``ref``)."""
