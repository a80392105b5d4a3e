"""Entry points run as ``python3 -m dist_gnn_tpu_torch.scripts.<name>``."""
