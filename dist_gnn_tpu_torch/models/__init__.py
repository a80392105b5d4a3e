from dist_gnn_tpu_torch.models.sage import SAGE  # noqa: F401
