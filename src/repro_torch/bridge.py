"""Carry an index built by the JAX package over to the port.

This system has no weights: its state is the index. ``index_from_arrays``
takes the fields of the reference's ``BlockedImpactIndex`` as numpy arrays
(and ints) and returns the port's index on ``device``, so both packages
search the same arrays; ``compressed_from_arrays`` does the same for the
reference's ``CompressedImpactIndex``. The port never imports the reference; callers
convert, e.g. ``{f.name: np.asarray(getattr(idx, f.name)) for f in
dataclasses.fields(idx)}``.
"""
from __future__ import annotations

import numpy as np

from .core.index import TENSOR_FIELDS, BlockedImpactIndex, index_from_layout
from .index.compressed import index_from_fields

SCALAR_FIELDS = ("n_docs", "n_terms", "tile_size", "n_tiles", "pad_len")


def index_from_arrays(fields: dict[str, np.ndarray],
                      device="cuda") -> BlockedImpactIndex:
    """The port's ``BlockedImpactIndex`` on ``device`` from the reference
    index's fields. Docids and ``tile_ptr`` become int32, weights and
    maxima float32; ``orig_of_new`` (optional) stays a host array."""
    missing = [f for f in SCALAR_FIELDS + TENSOR_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")
    lay = {f: int(np.asarray(fields[f])) for f in SCALAR_FIELDS}
    lay.update({f: np.asarray(fields[f]) for f in TENSOR_FIELDS})
    orig = fields.get("orig_of_new")
    lay["orig_of_new"] = None if orig is None else np.asarray(orig)
    return index_from_layout(lay, device)


# The port's CompressedImpactIndex on ``device`` from the reference
# compressed index's fields (numpy arrays in its dtypes, and ints):
# ``packed`` becomes a bitcast int32, ``first`` int32, the rest keeps its
# dtype; ``orig_of_new`` (optional) stays a host array.
compressed_from_arrays = index_from_fields
