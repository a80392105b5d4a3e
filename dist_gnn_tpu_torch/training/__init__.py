from dist_gnn_tpu_torch.training.trainer import Trainer  # noqa: F401
