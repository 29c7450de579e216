# Distributed substrate on torch.distributed: the collectives of the JAX
# package's repro.dist (each rank passes its own contribution), gradient
# compression and straggler handling. The sharding rules are not ported yet.
from .collectives import (hierarchical_all_reduce, reduce_scatter,  # noqa: F401
                          ring_all_gather, ring_all_reduce, ring_gather_stack)
from .compression import (CompressionConfig, compress_with_feedback,  # noqa: F401
                          compression_ratio, init_error_feedback, topk_sparsify)
from .straggler import StragglerConfig, StragglerMonitor  # noqa: F401
