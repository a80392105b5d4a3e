"""The distributed package on ``torch.distributed``: the mesh, the sharded
feature store and graph, ``DistTrainer``, the ring full-graph inference,
and the distributed host-resident tiers (``DistHostFeatureStore``,
``DistHostCSCStore``, ``DistHostTrainer``); counterpart of
``dist_gnn_tpu/parallel`` on the flat mesh and on the two-tier
``('host', 'data')`` mesh with its hierarchical exchange.
``initialize_distributed`` joins the process group that ``make_mesh``
reads."""

from dist_gnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: F401
from dist_gnn_tpu_torch.parallel.feature_store import ShardedFeatureStore  # noqa: F401
from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer  # noqa: F401
from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore  # noqa: F401
from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer, DistStaged  # noqa: F401
