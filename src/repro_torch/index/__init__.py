"""Compressed blocked-impact index storage (the q8 gather kind).

``CompressedImpactIndex`` keeps the BII tile geometry and exact fp32
bounds while storing postings as delta + bit-packed doc offsets and
int8-quantized impacts (per-(term, tile) fp16 scale/zero). It plugs into
every traversal executor through ``core.index.dispatch_gather`` (plain
decode) and the decode-in-kernel scorers ``guided_score_tile_q`` /
``guided_score_chunk_q``. Built in one shot by ``compress_index``.
"""
from . import codec  # noqa: F401
from .compressed import (CompressedImpactIndex, compress_index,  # noqa: F401
                         encode_runs, from_encoded_grids, gather_tile_q,
                         gather_tile_q_raw, index_from_fields)
