from .ops import (embedding_bag, segment_softmax,  # noqa: F401
                  scatter_mean, degree)
