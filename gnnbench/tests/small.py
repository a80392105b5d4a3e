"""Small configurations of the benchmark's cells, for tests on the CPU."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def config(name: str, nodes: int = 3000, edges: int = 30000, train: int = 600) -> dict:
    cfg = json.loads((ROOT / "gnnbench" / "configs" / f"{name}.json").read_text())
    cfg["graph"].update(num_nodes=nodes, num_undirected_edges=edges, num_in_edges=2 * edges, num_train_nodes=train)
    return cfg


TRAIN = {"batch_per_rank": 128}
INFER = {"sample_rows": 500}
