"""Fused LM exit head: CUDA kernel wrapper (``kernel``) and plain torch
version (``ref``)."""
