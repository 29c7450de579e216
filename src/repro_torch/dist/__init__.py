# Distributed substrate on torch.distributed: the collectives of the JAX
# package's repro.dist (each rank passes its own contribution), the
# sharding rules (per-dimension specs, placed as DTensors on a DeviceMesh),
# gradient compression and straggler handling.
from .collectives import (hierarchical_all_reduce, reduce_scatter,  # noqa: F401
                          ring_all_gather, ring_all_reduce, ring_gather_stack)
from .compression import (CompressionConfig, compress_with_feedback,  # noqa: F401
                          compression_ratio, init_error_feedback, topk_sparsify)
from .sharding import (P, activation_rules, input_shardings,  # noqa: F401
                       opt_shardings, param_shardings, placements)
from .straggler import StragglerConfig, StragglerMonitor  # noqa: F401
