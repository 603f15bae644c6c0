"""Fused difficulty estimator: CUDA kernel wrapper (``kernel``) and
plain torch version (``ref``)."""
