"""Block parallelism of the port: the JAX package's parallel/ surface.

``mesh``: the mesh of a node's cards and the stream-level window launches
over it; ``sharded``: whole-file encode and decode with each window's
blocks split over the mesh (``sfq-torch --sharded``); ``gather``: the
ordered ragged gather of one payload per process over torch.distributed;
``multihost``: the multi-process workflow (one process per host or card,
each coding a contiguous run of blocks, shard containers merged).
"""
