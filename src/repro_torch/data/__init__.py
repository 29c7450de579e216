from .corpus import (CorpusChunk, SyntheticCorpus, make_corpus,  # noqa: F401
                     synthetic_chunk_stream)
from .builder import StreamingIndexBuilder  # noqa: F401
