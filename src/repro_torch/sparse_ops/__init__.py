from .ops import (embedding_bag, gather_embedding_bag,  # noqa: F401
                  segment_softmax, scatter_mean, degree, take_rows)
