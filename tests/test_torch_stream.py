"""The port's data streams (``repro_torch.data.stream``) against the
reference's: the reference's 5 cases of ``tests/test_data_pipeline.py``
on the port, each also holding every batch bit-equal to the reference's
(both draw the same numpy streams in the same order; the port returns
int32 / float32 tensors on the device asked for)."""
import numpy as np
import torch

from repro.data import stream as J
from repro_torch.data.stream import (GraphStore, lm_batch, molecule_batch,
                                     pair_batch, recsys_batch)


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w)
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu"
            g = g.numpy()
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_lm_batch_deterministic_per_step():
    a = lm_batch(5, batch=4, seq=16, vocab=100, device="cpu")
    b = lm_batch(5, batch=4, seq=16, vocab=100, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = lm_batch(6, batch=4, seq=16, vocab=100, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].max()) < 100
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    for step in (0, 5):
        _equal(lm_batch(step, batch=4, seq=16, vocab=100, seed=3,
                        device="cpu"),
               J.lm_batch(step, batch=4, seq=16, vocab=100, seed=3))


def test_pair_batch_salient_terms_shared():
    b = pair_batch(3, batch=4, seq=16, vocab=100, n_rel_terms=4,
                   device="cpu")
    assert torch.equal(b["query"][:, :4], b["doc_pos"][:, :4])
    _equal(b, J.pair_batch(3, batch=4, seq=16, vocab=100, n_rel_terms=4))


def test_graph_store_sampler_shapes_and_locality():
    store = GraphStore(n_nodes=1000, n_edges=8000, d_feat=16, n_classes=5)
    sub = store.sample(0, batch_nodes=32, fanouts=(5, 3))
    n = sub["x"].shape[0]
    assert sub["x"].shape == (n, 16)
    assert sub["edge_src"].max() < n and sub["edge_dst"].max() < n
    assert sub["edge_src"].shape == sub["edge_dst"].shape
    assert sub["train_mask"].sum() == 32
    sub2 = store.sample(0, batch_nodes=32, fanouts=(5, 3))
    np.testing.assert_array_equal(sub["edge_src"], sub2["edge_src"])
    sub3 = store.sample(1, batch_nodes=32, fanouts=(5, 3))
    assert sub3["x"].shape[0] > 0
    ref = J.GraphStore(n_nodes=1000, n_edges=8000, d_feat=16, n_classes=5)
    for name in ("src", "dst", "indptr"):
        np.testing.assert_array_equal(getattr(store, name),
                                      getattr(ref, name))
    for step in (0, 1):
        _equal(store.sample(step, batch_nodes=32, fanouts=(5, 3)),
               ref.sample(step, batch_nodes=32, fanouts=(5, 3)))


def test_molecule_batch_energy_depends_on_geometry():
    a = molecule_batch(0, batch=4, atoms=8, edges=16, n_types=10,
                       device="cpu")
    assert bool(torch.isfinite(a["energy"]).all())
    assert int(a["z"].min()) >= 1
    _equal(a, J.molecule_batch(0, batch=4, atoms=8, edges=16, n_types=10))


def test_recsys_batches():
    from repro.models.recsys import DINConfig as JDIN
    from repro.models.recsys import DLRMConfig as JDLRM
    from repro_torch.models.recsys import DINConfig, DLRMConfig
    d = recsys_batch(2, kind="dlrm", cfg=DLRMConfig(vocab_per_field=50),
                     batch=8, device="cpu")
    assert d["sparse"].shape == (8, 26, 1)
    assert int(d["sparse"].max()) < 50
    _equal(d, J.recsys_batch(2, kind="dlrm",
                             cfg=JDLRM(vocab_per_field=50), batch=8))
    d = recsys_batch(2, kind="din", cfg=DINConfig(n_items=30), batch=8,
                     device="cpu")
    assert d["hist"].shape == (8, 100)
    _equal(d, J.recsys_batch(2, kind="din", cfg=JDIN(n_items=30), batch=8))
