from dist_gnn_tpu_torch.training.trainer import Trainer, make_optimizer, masked_nll_loss  # noqa: F401
from dist_gnn_tpu_torch.training.pipeline import HostTierTrainer  # noqa: F401
