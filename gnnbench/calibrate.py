"""The readings that the limits of ``gnnbench/limits/`` are set from.

    python3 gnnbench/calibrate.py --workload <name> --seeds <n,n,...> [--fault-seeds <n,...>]

For each seed, in one process and at the cell's own size (the graph made
and the caps tuned once, the weights and keys drawn per seed): the numbers
that decide ``correct`` for the program (the lower readings), for the
control, the plain reference computed in float8 (e4m3) where the
configuration computes in bfloat16, put in the program's place, and, on
the fault seeds, for the program with one fault planted underneath:

* ``half_batch``: the loss leaves out the second half of the batch and
  takes the mean over the rest;
* ``id_altered``: one sampled neighbour id is changed where the sampler
  produces it;
* ``answer_altered`` (full-graph inference): node 0's output row is
  replaced by node 1's where the pass produces it;
* ``half_rows_zeroed`` (full-graph inference): half of the output rows
  come back as zero.

A step that leaves the state unchanged (``unchanged``: the parameters put
back after each step) needs no run on the card: its parameters' change is
0, so the worst leaf's ``update_gap`` reads 1; the tests plant it.  Each reading is
one JSON line on standard output.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The program with ``fault`` planted underneath (module attributes
    swapped for the duration)."""
    import torch

    from dist_gnn_tpu_torch import sampler as sampler_mod
    from dist_gnn_tpu_torch.models import inference as inference_mod
    from dist_gnn_tpu_torch.training import trainer as trainer_mod

    saved = []

    def swap(mod, name, new):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    if fault == "half_batch":
        loss = trainer_mod.masked_nll_loss

        def half(model, dedup_last, blocks, feats, labels, seed_mask, rng):
            keep = torch.arange(seed_mask.shape[0], device=seed_mask.device) < seed_mask.shape[0] // 2
            return loss(model, dedup_last, blocks, feats, labels, seed_mask & keep, rng)

        swap(trainer_mod, "masked_nll_loss", half)
    elif fault == "id_altered":
        sample = sampler_mod.sample_neighbors

        def altered(graph, seeds, k, replace, key):
            nb = sample(graph, seeds, k, replace, key)
            ids = nb.ids.clone()
            ids[0, 0] = torch.where(nb.mask[0, 0], (ids[0, 0] + 1) % graph.num_nodes, ids[0, 0])
            return nb._replace(ids=ids)

        swap(sampler_mod, "sample_neighbors", altered)
    elif fault == "unchanged":
        step = trainer_mod.Trainer.train_step

        def kept(self, *args, **kwargs):
            before = [p.detach().clone() for p in self.model.parameters()]
            out = step(self, *args, **kwargs)
            with torch.no_grad():
                for p, b in zip(self.model.parameters(), before):
                    p.copy_(b)
            return out

        swap(trainer_mod.Trainer, "train_step", kept)
    elif fault in ("answer_altered", "half_rows_zeroed"):
        full = inference_mod.full_graph_inference

        def wrong(*args, **kwargs):
            out = full(*args, **kwargs).clone()
            if fault == "answer_altered":
                out[0] = out[1]
            else:
                out[out.shape[0] // 2 :] = 0
            return out

        swap(inference_mod, "full_graph_inference", wrong)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for mod, name, old in reversed(saved):
            setattr(mod, name, old)


def train_readings(cell, seed: int, faults: List[str]) -> List[Dict]:
    """The training readings of one seed on ``cell`` (a ``TrainCell``)."""
    from gnnbench import common
    from gnnbench.reference import models as ref_models

    n = int(cell.traffic["check_steps"])

    def program_run(fault: str = "") -> Dict:
        cell.reseed(seed)
        cell.build_program()
        with planted(fault) if fault else contextlib.nullcontext():
            cell.check_steps(n)
        cell.free_program()
        return cell.captured

    def counts(ref: Dict) -> Dict:
        return {k: ref[k] for k in common.COUNTED}

    prog = program_run()
    ref = cell.reference()
    out = [{"kind": "program", **common.train_checks(dict(prog, **counts(ref)), ref)}]
    ctrl = cell.reference(ref_models.fp8, compare=False)
    out.append({"kind": "control", **common.train_checks(
        dict(ctrl, blocks_differing=0, rows_differing=0, logit_gap=cell.control_logit_gap(ctrl, ref)), ref)})
    for fault in faults:
        got = program_run(fault)
        out.append({"kind": fault, **common.train_checks(dict(got, **counts(cell.reference())), ref)})
        cell.captured = prog
    return out


def infer_readings(cell, seed: int, faults: List[str]) -> List[Dict]:
    """The full-graph readings of one seed on ``cell`` (an ``InferCell``)."""
    from gnnbench.drivers.infer_full import output_gap
    from gnnbench.reference import models as ref_models

    cell.reseed(seed)

    def program_run(fault: str = ""):
        cell.build_program()
        cell.kept, cell.last = [], None
        with planted(fault) if fault else contextlib.nullcontext():
            cell._keep(cell.one_pass())
        cell.free_program()
        return cell.kept, cell.last

    kept, last = program_run()
    ref = cell.reference()
    out = [{"kind": "program", "output_gap": output_gap(kept, last, cell.rows, ref)}]
    ctrl = cell.reference(ref_models.fp8)
    out.append({"kind": "control", "output_gap": output_gap([ctrl[cell.rows]], ctrl, cell.rows, ref)})
    del ctrl
    for fault in faults:
        kept, last = program_run(fault)
        out.append({"kind": fault, "output_gap": output_gap(kept, last, cell.rows, ref)})
    return out


def make_cell(kind: str, cfg: Dict, traffic: Dict, seed: int, device):
    if kind == "train":
        from gnnbench.drivers.train import TrainCell

        return TrainCell(cfg, traffic, seed, device)
    else:
        from gnnbench.drivers.infer_full import InferCell

        return InferCell(cfg, traffic, seed, device)


FAULTS = {"train": ["half_batch", "id_altered"], "infer_full": ["answer_altered", "half_rows_zeroed"]}
READINGS = {"train": train_readings, "infer_full": infer_readings}


def readings(root: Path, workload: str, seeds: List[int], fault_seeds: List[int], device,
             cfg_override=None, traffic_override=None) -> Iterator[Dict]:
    from gnnbench import harness

    manifest = harness.load_json(root / "BENCHMARK.json")
    cell, conf = harness.find_cell(manifest, workload)
    cfg = cfg_override if cfg_override is not None else harness.load_json(root / conf["file"])
    traffic = dict(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"),
                   **(traffic_override or {}))
    kind = traffic["driver"]
    seeds = list(dict.fromkeys(seeds + fault_seeds))
    cell = make_cell(kind, cfg, traffic, seeds[0], device)
    for seed in seeds:
        t0 = time.perf_counter()
        faults = FAULTS[kind] if seed in fault_seeds else []
        for r in READINGS[kind](cell, seed, faults):
            yield {"workload": workload, "seed": seed, **r, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for r in readings(ROOT, args.workload, seeds, fault_seeds, torch.device("cuda", 0)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
