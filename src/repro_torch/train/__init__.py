# Training substrate: AdamW, atomic checkpoints, the fault-tolerant Trainer.
from .optimizer import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                        cosine_schedule)
