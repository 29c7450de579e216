from .base import ArchSpec  # noqa: F401
from .registry import ARCH_IDS, all_cells, get_arch  # noqa: F401
from .shapes import (GNN_SHAPE_DEFS, LM_SHAPE_DEFS,  # noqa: F401
                     RECSYS_SHAPE_DEFS)
