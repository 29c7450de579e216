"""dlrm-rm2 [arXiv:1906.00091]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import DLRMConfig


def _full():
    return DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64,
                      vocab_per_field=1_000_000,
                      bot_mlp=(13, 512, 256, 64),
                      top_mlp_hidden=(512, 512, 256, 1), multi_hot=1)


def _smoke():
    return DLRMConfig(n_dense=13, n_sparse=6, embed_dim=16,
                      vocab_per_field=1000, bot_mlp=(13, 32, 16),
                      top_mlp_hidden=(32, 1), multi_hot=1)


ARCH = ArchSpec(arch_id="dlrm-rm2", family="recsys",
                source="arXiv:1906.00091",
                make_config=_full, make_smoke=_smoke, shapes=RECSYS_SHAPES)
