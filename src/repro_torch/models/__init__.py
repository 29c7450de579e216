from .transformer import TransformerConfig, MoEConfig, Rules  # noqa: F401
from .schnet import SchNetConfig  # noqa: F401
from .recsys import (DLRMConfig, DINConfig, TwoTowerConfig,  # noqa: F401
                     Bert4RecConfig)
