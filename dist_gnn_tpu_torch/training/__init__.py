from dist_gnn_tpu_torch.training.trainer import (  # noqa: F401
    Trainer,
    dist_masked_nll_loss,
    make_optimizer,
    masked_nll_loss,
)
from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer  # noqa: F401
