"""two-tower-retrieval [RecSys'19 (YouTube); unverified]: embed_dim=256
tower_mlp=1024-512-256 interaction=dot, sampled-softmax retrieval."""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import TwoTowerConfig


def _full():
    return TwoTowerConfig(embed_dim=256, tower_mlp=(1024, 512, 256),
                          n_user_feats=500_000, n_items=2_000_000,
                          user_bag=16, feat_dim=256, n_negatives=1024)


def _smoke():
    return TwoTowerConfig(embed_dim=32, tower_mlp=(64, 32),
                          n_user_feats=1000, n_items=2000, user_bag=8,
                          feat_dim=32, n_negatives=16)


ARCH = ArchSpec(arch_id="two-tower-retrieval", family="recsys",
                source="Yi et al., RecSys'19 (YouTube)",
                make_config=_full, make_smoke=_smoke, shapes=RECSYS_SHAPES,
                notes="retrieval_cand scores every candidate exhaustively")
