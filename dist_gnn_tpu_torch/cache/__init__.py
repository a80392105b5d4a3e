from dist_gnn_tpu_torch.cache.cost_model import CostModel  # noqa: F401
from dist_gnn_tpu_torch.cache.policy import (  # noqa: F401
    get_cache_nids_auto,
    get_cache_nids_selfish,
    get_cache_nids_selfless,
)
