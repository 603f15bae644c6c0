"""Fused exit gate: CUDA kernel wrapper (``kernel``) and plain torch
version (``ref``)."""
