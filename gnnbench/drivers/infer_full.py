"""Driver ``infer_full``: ``full_graph_inference`` of the model over the
whole graph, pass after pass, on one card.

Set-up makes the configuration's graph and features on the card (from its
``graph_seed``), the weights and a sample of ``sample_rows`` node rows from
the run's seed, the host copy of the graph that ``full_graph_inference``
takes, and the model of the configuration's family
(``gnnbench/programs``); one pass warms the path up.  Every pass of the
window keeps its output at the sampled rows, and the last pass its whole
[N, C] output.  After the window and the memory reading, the family's
plain reference (``full`` of ``gnnbench/reference/<family>.py``) computes
the pass in float32 and every kept output is compared with it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from gnnbench import common, graphgen, programs, trace
from gnnbench.reference import models as ref_models

STEADY_S = 2.0  # host seconds of passes timed untraced, in steady state, beside the traced ones


class InferCell:
    """The cell's graph and program, and the run's weights and sampled rows
    (:meth:`reseed` draws them anew for another seed)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        from dist_gnn_tpu_torch.graph import HostGraph

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.inputs = inp = graphgen.make_graph(cfg, cfg["graph"]["graph_seed"], device)
        self.hg = HostGraph(indptr=inp["indptr"].cpu().numpy(), indices=inp["indices"].cpu().numpy())
        self.kept: List[torch.Tensor] = []
        self.last = None
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """The weights and the sampled rows of ``seed``."""
        self.weights = common.make_weights(self.cfg, seed, self.device)
        g = graphgen.generator(seed, self.device, common.SAMPLE_ROWS)
        self.rows = torch.randperm(self.hg.num_nodes, generator=g, device=self.device)[
            : int(self.traffic["sample_rows"])]

    def build_program(self) -> None:
        self.model = programs.build(self.cfg, self.device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.weights[name])

    def one_pass(self) -> torch.Tensor:
        from dist_gnn_tpu_torch.models.inference import full_graph_inference

        return full_graph_inference(self.model, None, self.hg, self.inputs["features"], device=self.device)

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.one_pass()
        common.synchronize(self.device)

    def _keep(self, out: torch.Tensor) -> None:
        self.kept.append(out[self.rows])
        self.last = out

    def window(self, seconds: float) -> Dict:
        common.synchronize(self.device)
        t0 = time.perf_counter()
        passes = 0
        while time.perf_counter() - t0 < seconds:
            self._keep(self.one_pass())
            passes += 1
        common.synchronize(self.device)
        return {"t0": t0, "window_s": time.perf_counter() - t0, "passes": passes}

    def traced(self, n: int) -> Dict:
        def work():
            for _ in range(n):
                self._keep(self.one_pass())

        pass_s, timed, _ = trace.steady_seconds(self.one_pass, warm=1, min_seconds=STEADY_S)
        red, _ = trace.traced(work)
        return {"trace": red, "steady_pass_s": pass_s, "steady_passes": timed, "passes": n, "cfg": self.cfg,
                "family": self.cfg["model"]["family"], "num_nodes": self.hg.num_nodes,
                "num_edges": self.hg.num_edges}

    def free_program(self) -> None:
        del self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, q=ref_models.identity) -> torch.Tensor:
        inp = self.inputs
        return ref_models.full(self.cfg, self.weights, inp["indptr"], inp["indices"], inp["features"], q)


def output_gap(kept: List[torch.Tensor], last: torch.Tensor, rows: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of any kept output from the reference, over the
    reference's largest magnitude."""
    scale = float(ref.abs().max())
    gap = float((last.float() - ref).abs().max())
    want = ref[rows]
    for k in kept:
        gap = max(gap, float((k.float() - want).abs().max()))
    return gap / max(scale, 1e-30)


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace_on: bool, device: torch.device,
        t_start: float) -> Dict:
    cell = InferCell(cfg, traffic, seed, device)
    common.note("inputs made", t_start)
    cell.build_program()
    cell.warm(int(traffic["warm_passes"]))
    common.note("set-up done", t_start)
    out: Dict = {"failed": 0}
    if trace_on:
        out["record"] = cell.traced(int(traffic["trace_passes"]))
        out["attempted"] = int(traffic["trace_passes"])
    else:
        w = cell.window(seconds)
        layers = cfg["model"]["num_layers"]
        out["e2e"] = {"setup_s": w["t0"] - t_start,
                      "infer_edges_per_s": w["passes"] * layers * cell.hg.num_edges / w["window_s"]}
        out["attempted"] = w["passes"]
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.free_program()
    common.note("window closed", t_start)
    kept, last, rows = cell.kept, cell.last, cell.rows
    cell.kept, cell.last = [], None
    ref = cell.reference()
    out["checks"] = {"output_gap": output_gap(kept, last, rows, ref)}
    common.note("reference done", t_start)
    return out
