"""Block parallelism of the port: the JAX package's parallel/ surface.

Only its single-card form is ported (``mesh=None``): a window of blocks
coded together on one card, each stream's kernel launch taking every
block of the window. A mesh (multi-GPU) raises "multi-GPU not yet
ported"; it never runs on one card in its place.
"""

from __future__ import annotations


def single_card(mesh) -> None:
    """Refuse a mesh: the port has only the single-card form."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-GPU not yet ported in the torch port: pass mesh=None "
            "for the single-card window path")
