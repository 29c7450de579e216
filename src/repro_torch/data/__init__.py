from .corpus import (CorpusChunk, SyntheticCorpus, make_corpus,  # noqa: F401
                     synthetic_chunk_stream)
from .builder import StreamingIndexBuilder  # noqa: F401
from .stream import (GraphStore, lm_batch, molecule_batch,  # noqa: F401
                     pair_batch, recsys_batch, to_device)
