# Two-level guided traversal (2GTI) for learned sparse retrieval, on torch.
from .align import MergedPostings, merge_models, misalignment_fraction  # noqa: F401
from .bm25 import Bm25Stats, build_bm25  # noqa: F401
from .index import BlockedImpactIndex, build_index  # noqa: F401
from .metrics import evaluate_run, mean_and_p99  # noqa: F401
from .plan import QueryPlan, plan_query  # noqa: F401
from .sparse import SparseModel, from_coo  # noqa: F401
from .traversal import (RetrievalResult, retrieve_batched,  # noqa: F401
                        retrieve_sequential)
from .twolevel import TwoLevelParams  # noqa: F401
from . import oracle, plan, twolevel  # noqa: F401
