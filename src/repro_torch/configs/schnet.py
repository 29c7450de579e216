"""schnet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10.

One trunk, two input modes: molecule (atom types + positions) and graph
(linear feature embed; per-shape d_feat/classes applied by the step factory
via dataclasses.replace — full_graph_sm 1433/7, minibatch_lg 602/41,
ogb_products 100/47).
"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.schnet import SchNetConfig


def _full():
    return SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300,
                        cutoff=10.0, n_atom_types=100, n_out=1)


def _smoke():
    return SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=24,
                        cutoff=5.0, n_atom_types=16, n_out=1)


ARCH = ArchSpec(arch_id="schnet", family="gnn", source="arXiv:1706.08566",
                make_config=_full, make_smoke=_smoke, shapes=GNN_SHAPES)
