"""The port's GAT at the configuration's widths, on the fused attention
kernels where the configuration says ``fused``."""

from gnnbench.graphgen import DTYPES


def build(cfg, device):
    from dist_gnn_tpu_torch.models.gat import GAT

    m, g = cfg["model"], cfg["graph"]
    return GAT(g["feature_dim"], m["hidden"], g["num_classes"], m["num_layers"], num_heads=m["heads"],
               dropout=m["dropout"], negative_slope=m["negative_slope"],
               compute_dtype=DTYPES[m["compute_dtype"]], use_fused=bool(m["fused"]), device=device)
