"""The port's GraphSAGE (mean) at the configuration's widths."""

from gnnbench.graphgen import DTYPES


def build(cfg, device):
    from dist_gnn_tpu_torch.models.sage import SAGE

    m, g = cfg["model"], cfg["graph"]
    return SAGE(g["feature_dim"], m["hidden"], g["num_classes"], m["num_layers"],
                compute_dtype=DTYPES[m["compute_dtype"]], device=device, dropout=m["dropout"])
