"""The distributed package on ``torch.distributed``: the mesh, the sharded
feature store and graph, ``DistTrainer`` and the ring full-graph inference
(counterpart of ``dist_gnn_tpu/parallel``; its host-resident distributed
tiers, ``host_dist.py`` and ``host_struct.py``, come with the next slice).
``initialize_distributed`` joins the process group that ``make_mesh``
reads."""

from dist_gnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: F401
from dist_gnn_tpu_torch.parallel.feature_store import ShardedFeatureStore  # noqa: F401
from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer  # noqa: F401
