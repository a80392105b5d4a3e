from dist_gnn_tpu_torch.models.gat import GAT  # noqa: F401
from dist_gnn_tpu_torch.models.sage import SAGE  # noqa: F401
