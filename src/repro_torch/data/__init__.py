from .corpus import SyntheticCorpus, make_corpus  # noqa: F401
