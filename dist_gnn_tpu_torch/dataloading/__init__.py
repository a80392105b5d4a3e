from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator  # noqa: F401
