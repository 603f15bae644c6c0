"""Procedural synthetic datasets (host-side numpy)."""
