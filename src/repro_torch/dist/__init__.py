# Distributed substrate on torch.distributed: the collectives of the JAX
# package's repro.dist (each rank passes its own contribution). Sharding
# rules, gradient compression and straggler handling are not ported yet.
from .collectives import (hierarchical_all_reduce, reduce_scatter,  # noqa: F401
                          ring_all_gather, ring_all_reduce, ring_gather_stack)
