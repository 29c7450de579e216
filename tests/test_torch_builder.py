"""The port's StreamingIndexBuilder and chunk streams, on the CPU, against
the port's one-shot ``compress_index`` and against the JAX package's
builder.

The first eight tests are ``tests/test_builder.py`` on the port
(``finalize(device="cpu")``): a chunked build equals the one-shot
compress, ``add_chunk`` is idempotent, the geometry is validated, chunk
ids must be contiguous, the synthetic stream is seed-pure, a build
SIGKILLed in its durability window resumes to the same index, and the
2^20-doc build stays under 25% of the fp32 bytes. The rest hold the port
to the reference: its chunk streams (``synthetic_chunk_stream``,
``SyntheticCorpus.iter_chunks``) are array-equal to the reference's for
the same seed; its ``finalize`` is array-equal, field by field, to the
reference builder's; and a spill directory either package wrote
finalizes in the other to the same arrays.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.data import StreamingIndexBuilder as JaxBuilder
from repro.data import make_corpus as jax_make_corpus
from repro.data import synthetic_chunk_stream as jax_chunk_stream
from repro_torch.data import (StreamingIndexBuilder, make_corpus,
                              synthetic_chunk_stream)
from repro_torch.index import compress_index
from repro_torch.index.compressed import SCALAR_FIELDS, TENSOR_FIELDS

N_DOCS = 2048
TILE = 256
CHUNK_DOCS = 512  # 4 chunks, 2 tiles each
CORPUS = dict(n_docs=N_DOCS, n_terms=256, n_queries=4, avg_doc_terms=24,
              seed=5)
CHUNK_FIELDS = ("terms", "docids", "w_b", "w_l")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_indexes_equal(a, b):
    assert (a.n_docs, a.n_terms, a.n_tiles, a.nnz, a.pad_len) == \
        (b.n_docs, b.n_terms, b.n_tiles, b.nnz, b.pad_len)
    for name in TENSOR_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _assert_equal_to_reference(port, ref):
    """Every field of the port's index equals the reference's: scalars
    equal, tensors equal in value in the port's device dtypes (``packed``
    the int32 bitcast of the reference's uint32, ``first`` widened)."""
    for name in SCALAR_FIELDS:
        assert getattr(port, name) == int(getattr(ref, name)), name
    for name in TENSOR_FIELDS:
        want = np.asarray(getattr(ref, name))
        want = {"packed": lambda a: a.view(np.int32),
                "first": lambda a: a.astype(np.int32)}.get(
                    name, lambda a: a)(want)
        got = getattr(port, name).numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.orig_of_new is None and ref.orig_of_new is None


def _assert_chunks_equal(port, ref):
    assert [c.chunk_id for c in port] == [c.chunk_id for c in ref]
    for a, b in zip(port, ref):
        assert (a.doc_start, a.n_docs) == (b.doc_start, b.n_docs)
        for name in CHUNK_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus("splade_like", **CORPUS)


# -- tests/test_builder.py on the port -----------------------------------------

def test_chunked_equals_oneshot(corpus, tmp_path):
    oneshot = compress_index(corpus.merged("scaled"), tile_size=TILE,
                             device="cpu")
    b = StreamingIndexBuilder(tmp_path / "idx", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=CHUNK_DOCS)
    for ch in corpus.iter_chunks(CHUNK_DOCS):
        assert b.add_chunk(ch)
    _assert_indexes_equal(b.finalize(device="cpu"), oneshot)


def test_short_last_chunk(corpus, tmp_path):
    # the last chunk holds fewer docs than chunk_docs
    oneshot = compress_index(corpus.merged("scaled"), tile_size=TILE,
                             device="cpu")
    b = StreamingIndexBuilder(tmp_path / "idx", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=768)
    for ch in corpus.iter_chunks(768):  # 768 = 3 tiles; 2048 = 2x768+512
        b.add_chunk(ch)
    _assert_indexes_equal(b.finalize(device="cpu"), oneshot)


def test_add_chunk_idempotent(corpus, tmp_path):
    b = StreamingIndexBuilder(tmp_path / "idx", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=CHUNK_DOCS)
    chunks = list(corpus.iter_chunks(CHUNK_DOCS))
    for ch in chunks:
        assert b.add_chunk(ch) is True
    for ch in chunks:  # replay: every add is a recorded no-op
        assert b.add_chunk(ch) is False
    _assert_indexes_equal(b.finalize(device="cpu"),
                          compress_index(corpus.merged("scaled"),
                                         tile_size=TILE, device="cpu"))


def test_geometry_validation(corpus, tmp_path):
    with pytest.raises(ValueError, match="multiple of"):
        StreamingIndexBuilder(tmp_path / "a", n_terms=256, tile_size=256,
                              chunk_docs=300)
    StreamingIndexBuilder(tmp_path / "b", n_terms=256, tile_size=256,
                          chunk_docs=512)
    with pytest.raises(ValueError, match="geometry mismatch"):
        StreamingIndexBuilder(tmp_path / "b", n_terms=256, tile_size=128,
                              chunk_docs=512)
    # misplaced chunk: doc_start must equal chunk_id * chunk_docs
    b = StreamingIndexBuilder(tmp_path / "c", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=CHUNK_DOCS)
    ch = next(iter(corpus.iter_chunks(CHUNK_DOCS)))
    with pytest.raises(ValueError, match="starts at doc"):
        b.add_chunk(dataclasses.replace(ch, chunk_id=1))
    with pytest.raises(ValueError, match="no chunks"):
        StreamingIndexBuilder(tmp_path / "d", n_terms=256, tile_size=256,
                              chunk_docs=512).finalize(device="cpu")


def test_finalize_rejects_gaps(corpus, tmp_path):
    b = StreamingIndexBuilder(tmp_path / "idx", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=CHUNK_DOCS)
    for ch in corpus.iter_chunks(CHUNK_DOCS):
        if ch.chunk_id != 1:  # a hole in the chunk sequence
            b.add_chunk(ch)
    with pytest.raises(ValueError, match="contiguous"):
        b.finalize(device="cpu")


def test_stream_chunks_are_seed_pure():
    """Each chunk is a pure function of (seed, chunk_id): regenerating
    chunk 2 through start_chunk matches the full stream, which makes
    "reopen and replay from the first missing chunk" a valid resume."""
    full = list(synthetic_chunk_stream(4, 512, 128, seed=9))
    tail = list(synthetic_chunk_stream(4, 512, 128, seed=9, start_chunk=2))
    assert [c.chunk_id for c in tail] == [2, 3]
    _assert_chunks_equal(full[2:], tail)


_CRASH_CHILD = textwrap.dedent("""\
    import os, signal, sys
    from repro_torch.data import StreamingIndexBuilder, synthetic_chunk_stream

    out = sys.argv[1]

    class CrashingBuilder(StreamingIndexBuilder):
        calls = 0
        def _write_manifest(self):
            # call 1: __init__; calls 2-3: chunks 0-1; call 4: chunk 2 -
            # die with the spill on disk but unrecorded (the orphan-spill
            # window between os.replace and the manifest update)
            CrashingBuilder.calls += 1
            if CrashingBuilder.calls == 4:
                os.kill(os.getpid(), signal.SIGKILL)
            super()._write_manifest()

    b = CrashingBuilder(out, n_terms=128, tile_size=256, chunk_docs=512)
    for ch in synthetic_chunk_stream(4, 512, 128, seed=9):
        b.add_chunk(ch)
    raise SystemExit("child survived past the kill point")
""")


def test_kill_and_resume(tmp_path):
    """A child build SIGKILLed with chunk 2 spilled but not recorded
    resumes to the index of a build that never crashed, which is also the
    reference builder's index of the same stream."""
    out = tmp_path / "idx"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, "-c", _CRASH_CHILD, str(out)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr

    # crash state: chunks 0-1 recorded, chunk 2 spilled but orphaned
    b = StreamingIndexBuilder(out, n_terms=128, tile_size=256,
                              chunk_docs=512)
    assert b.completed_chunks == [0, 1]
    assert (out / "chunk_00002.npz").exists()

    # resume: replay from the first missing chunk; the orphan spill is
    # written again, recorded chunks are skipped
    start = min(set(range(4)) - set(b.completed_chunks))
    assert start == 2
    for ch in synthetic_chunk_stream(4, 512, 128, seed=9, start_chunk=start):
        assert b.add_chunk(ch) is True
    resumed = b.finalize(device="cpu")

    clean = StreamingIndexBuilder(tmp_path / "clean", n_terms=128,
                                  tile_size=256, chunk_docs=512)
    for ch in synthetic_chunk_stream(4, 512, 128, seed=9):
        clean.add_chunk(ch)
    _assert_indexes_equal(resumed, clean.finalize(device="cpu"))

    ref = JaxBuilder(tmp_path / "ref", n_terms=128, tile_size=256,
                     chunk_docs=512)
    for ch in jax_chunk_stream(4, 512, 128, seed=9):
        ref.add_chunk(ch)
    _assert_equal_to_reference(resumed, ref.finalize())


@pytest.mark.slow
def test_million_doc_build():
    """The acceptance-scale build: 2^20 docs streamed through the builder;
    the compressed index stays under 25% of the fp32 bytes."""
    import tempfile
    n_chunks, chunk_docs = 16, 65536
    with tempfile.TemporaryDirectory() as d:
        b = StreamingIndexBuilder(d, n_terms=256, tile_size=8192,
                                  chunk_docs=chunk_docs)
        for ch in synthetic_chunk_stream(n_chunks, chunk_docs, 256,
                                         avg_doc_terms=64, seed=0,
                                         zipf_a=1.2):
            b.add_chunk(ch)
        index = b.finalize(device="cpu")
    assert index.n_docs == n_chunks * chunk_docs == 1 << 20
    ratio = index.nbytes()["total"] / index.fp32_nbytes()
    assert ratio < 0.25, f"compression ratio {ratio:.3f} >= 0.25"


# -- the port against the reference -------------------------------------------

@pytest.mark.parametrize("source", ["synthetic_chunk_stream", "iter_chunks"])
def test_chunk_streams_equal_reference(source):
    """For the same seed the port's chunks are array-equal (values and
    dtypes) to the reference's: the seed-pure stream, from its first chunk
    and from a later one, and a seeded corpus cut into chunks with a short
    last one."""
    if source == "synthetic_chunk_stream":
        for start in (0, 3):
            kw = dict(avg_doc_terms=16, seed=4, start_chunk=start,
                      zipf_a=1.2)
            _assert_chunks_equal(
                list(synthetic_chunk_stream(5, 1024, 300, **kw)),
                list(jax_chunk_stream(5, 1024, 300, **kw)))
    else:
        for fill in ("scaled", "zero"):
            _assert_chunks_equal(
                list(make_corpus("splade_like", **CORPUS).iter_chunks(
                    768, fill)),
                list(jax_make_corpus("splade_like", **CORPUS).iter_chunks(
                    768, fill)))


def test_finalize_equals_reference_builder(small_corpus, tmp_path):
    """On the conftest corpus the port's builder finalizes to the
    reference builder's index, field by field, and both equal the port's
    one-shot ``compress_index``."""
    port_corpus = make_corpus("splade_like", n_docs=2048, n_terms=512,
                              n_queries=12, n_q_terms=5, n_rel=3,
                              avg_doc_terms=24, seed=7)
    port = StreamingIndexBuilder(tmp_path / "port", n_terms=512,
                                 tile_size=TILE, chunk_docs=CHUNK_DOCS)
    for ch in port_corpus.iter_chunks(CHUNK_DOCS):
        port.add_chunk(ch)
    ref = JaxBuilder(tmp_path / "ref", n_terms=512, tile_size=TILE,
                     chunk_docs=CHUNK_DOCS)
    for ch in small_corpus.iter_chunks(CHUNK_DOCS):
        ref.add_chunk(ch)
    got = port.finalize(device="cpu")
    _assert_equal_to_reference(got, ref.finalize())
    _assert_indexes_equal(got, compress_index(
        port_corpus.merged("scaled"), tile_size=TILE, device="cpu"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_spill_directory_finalizes_in_either_package(corpus, tmp_path,
                                                      writer):
    """The on-disk format is shared: chunks that one package's
    ``add_chunk`` spilled (the first two of four, the rest added by the
    other package on resume) finalize in both packages to the same
    arrays."""
    ref_corpus = jax_make_corpus("splade_like", **CORPUS)
    first, second = ((ref_corpus, JaxBuilder), (corpus, StreamingIndexBuilder))
    if writer == "port":
        first, second = second, first
    out = tmp_path / "idx"
    geom = dict(n_terms=corpus.n_terms, tile_size=TILE, chunk_docs=CHUNK_DOCS)
    b = first[1](out, **geom)
    for ch in first[0].iter_chunks(CHUNK_DOCS):
        if ch.chunk_id < 2:
            b.add_chunk(ch)
    b = second[1](out, **geom)
    assert b.completed_chunks == [0, 1]
    for ch in second[0].iter_chunks(CHUNK_DOCS):
        b.add_chunk(ch)
    got = StreamingIndexBuilder(out, **geom).finalize(device="cpu")
    _assert_equal_to_reference(got, JaxBuilder(out, **geom).finalize())
    _assert_indexes_equal(got, compress_index(corpus.merged("scaled"),
                                              tile_size=TILE, device="cpu"))


def test_finalize_on_cuda_without_gpu_raises(corpus, tmp_path):
    """``finalize`` puts the index on the card by default; without a GPU
    it raises before any work, as ``Retriever.open(device="cuda")``
    does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b = StreamingIndexBuilder(tmp_path / "idx", n_terms=corpus.n_terms,
                              tile_size=TILE, chunk_docs=CHUNK_DOCS)
    b.add_chunk(next(iter(corpus.iter_chunks(CHUNK_DOCS))))
    with pytest.raises(RuntimeError, match="CUDA"):
        b.finalize()
