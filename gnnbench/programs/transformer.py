"""The port's graph transformer (UniMP's attention layer with a gated
residual) at the configuration's widths, on the attention kernels."""

from gnnbench.graphgen import DTYPES


def build(cfg, device):
    from dist_gnn_tpu_torch.models.transformer import GraphTransformer

    m, g = cfg["model"], cfg["graph"]
    return GraphTransformer(g["feature_dim"], m["hidden"], g["num_classes"], m["num_layers"], num_heads=m["heads"],
                            dropout=m["dropout"], compute_dtype=DTYPES[m["compute_dtype"]], device=device)
