"""Plain torch version of the paged KV gather.

The JAX reference (``repro/kernels/paged_gather/ref.py``) is a
``jnp.take`` over the page axis with ``mode="clip"`` and a reshape: page
ids outside [0, N) read the nearest valid page.  Torch indexing raises
on such ids instead, so they are clamped first.  A pure copy.
"""
from __future__ import annotations


def ref_paged_gather(pages, page_table):
    """pages (N, psz, ...), page_table (S, P) integer page ids.  Returns
    the dense per-slot view (S, P*psz, ...): slot i's pages concatenated
    in table order."""
    s, p = page_table.shape
    n, psz = pages.shape[:2]
    ids = page_table.reshape(-1).long().clamp(0, n - 1)
    return pages[ids].reshape(s, p * psz, *pages.shape[2:])
