"""Mini-batch node classification apps (``python -m
dist_gnn_tpu_torch.examples.graphsage.node_classification``)."""
