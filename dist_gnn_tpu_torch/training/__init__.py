from dist_gnn_tpu_torch.training.trainer import Trainer, make_optimizer, masked_nll_loss  # noqa: F401
