"""Driver ``train``: ``Trainer.train_step`` on one card, batch after batch.

Set-up makes the configuration's graph, features and labels on the card
(from its ``graph_seed``) and the weights from the run's seed, tunes the
frontier caps with the program's ``tune_sampler_for``, builds one
``Trainer`` of the configuration's family (``gnnbench/programs``), and
drives it through ``check_steps`` steps through the window's own call and
feed (consecutive batches of one epoch shuffle, so their rows all differ)
and then ``warm_steps`` more.  A forward pre-hook on the model keeps what the timed
path produced in those steps: the blocks the sampler gave and the rows K1
gathered (moved to the host), the loss, the first gradient as Adam holds
it (``exp_avg / (1 - beta1)`` after one step) and the parameters after the
last check step.  The same trainer then runs the window, or, with
``--trace 1``, a profiled stretch of ``trace_steps`` steps.

After the window and the memory reading, the program is freed and the
plain reference (``gnnbench/reference``) follows the check steps from the
same inputs, seeds and keys: it samples the blocks again, gathers the rows,
and runs the family's model (``gnnbench/reference/<family>.py``) in float32
with its own Adam.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from gnnbench import common, graphgen, programs, trace
from gnnbench.reference import models as ref_models
from gnnbench.reference import sampler as ref_sampler

FLUSH = 48  # masks summed into the edge count in one call
STEADY_S = 2.0  # host seconds of steps timed untraced, in steady state, beside the traced ones


class TrainCell:
    """The cell's graph, frontier caps and program, and the run's weights
    and feed (:meth:`reseed` draws them anew for another seed)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device, t_start: Optional[float] = None):
        from dist_gnn_tpu_torch.cache.autotune import tune_sampler_for
        from dist_gnn_tpu_torch.graph import Graph, HostGraph

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.inputs = inp = graphgen.make_graph(cfg, cfg["graph"]["graph_seed"], device)
        self.t_start = t_start
        indptr, indices = inp["indptr"], inp["indices"]
        if t_start is not None:
            common.synchronize(device)
            common.note("graph made", t_start)
        self.graph = Graph(indptr=indptr, indices=indices, probs=None, num_nodes=indptr.numel() - 1,
                           num_edges=indices.numel(), max_degree=int((indptr[1:] - indptr[:-1]).max()))
        self.fanout = tuple(traffic["fanout"])
        self.batch = int(traffic["batch_per_rank"])
        if traffic["replace"] or traffic["dedup_last"]:
            raise ValueError("the train driver runs without replacement and with a dedup-free last hop")
        hg = HostGraph(indptr=indptr.cpu().numpy(), indices=indices.cpu().numpy())
        self.caps = tuple(tune_sampler_for(hg, inp["train_idx"].cpu().numpy(), self.batch, self.fanout)
                          .frontier_caps)
        del hg
        if t_start is not None:
            common.note(f"frontier caps {self.caps}, max degree {self.graph.max_degree}", t_start)
        self.hops = ref_sampler.hop_sizes(self.batch, self.fanout, self.caps)
        self.drops = list(reversed(self.hops))[: len(self.fanout) - 1]
        self._sink = None
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """The weights, the seed order and the keys of ``seed``."""
        self.feed = common.Feed(self.inputs["train_idx"], self.batch, seed, self.device, self.hops, self.drops)
        self.weights = common.make_weights(self.cfg, seed, self.device)

    # ---- the program ------------------------------------------------------

    def build_program(self) -> None:
        from dist_gnn_tpu_torch.training.trainer import Trainer

        model = programs.build(self.cfg, self.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.weights[name])
        opt = self.cfg["model"]["optimizer"]
        self.trainer = Trainer(model, fan_out=self.fanout, lr=opt["lr"], weight_decay=opt["weight_decay"],
                               replace=False, frontier_caps=self.caps, dedup_last=False, device=self.device)
        self._hook = model.register_forward_pre_hook(self._on_forward)

    def _on_forward(self, module, args):
        if self._sink is not None:
            self._sink(args[0], args[1])

    def step(self):
        seeds, mask, keys = self.feed.next()
        inp = self.inputs
        out = self.trainer.train_step(self.graph, inp["features"], inp["labels"], seeds, mask, keys)
        return seeds, mask, keys, out

    def check_steps(self, n: int) -> None:
        """Drive the first ``n`` steps and keep what they produced (a
        forward hook keeps the logits)."""
        model, opt = self.trainer.model, self.trainer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        steps: List[Dict] = []
        loss: List[float] = []
        g1 = {}
        for t in range(n):
            got: Dict = {}

            def keep(blocks, x, got=got):
                got["blocks"] = [{f: v.cpu() if torch.is_tensor(v) else v for f, v in b._asdict().items()}
                                 for b in reversed(blocks)]
                got["feats"] = x.cpu()

            self._sink = keep
            hook = model.register_forward_hook(lambda m, a, y, got=got: got.update(logits=y.detach().cpu()))
            seeds, mask, (hop_keys, drop_keys), out = self.step()
            hook.remove()
            self._sink = None
            loss.append(float(out["loss"]))
            steps.append({"seeds": seeds.clone(), "mask": mask.clone(), "hop_keys": [k.clone() for k in hop_keys],
                          "drop_keys": [k.clone() for k in drop_keys], **got})
            if t == 0:
                g1 = {name: opt.state[p]["exp_avg"].detach() / (1 - beta1) for name, p in model.named_parameters()}
            if self.t_start is not None:
                common.note(f"check step {t} kept", self.t_start)
        delta = {name: p.detach() - self.weights[name] for name, p in model.named_parameters()}
        self.captured = {"steps": steps, "loss": loss, "g1": g1, "delta": delta}

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.step()
        common.synchronize(self.device)

    def window(self, seconds: float) -> Dict:
        masks: List[torch.Tensor] = []
        edges = torch.zeros((), dtype=torch.int64, device=self.device)

        def flush():
            nonlocal edges
            if masks:
                edges = edges + torch.cat([m.reshape(-1) for m in masks]).sum()
                masks.clear()

        self._sink = lambda blocks, x: masks.extend(b.neigh_mask for b in blocks)
        common.synchronize(self.device)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            steps += 1
            if len(masks) >= FLUSH:
                flush()
        flush()
        common.synchronize(self.device)
        t1 = time.perf_counter()
        self._sink = None
        return {"t0": t0, "window_s": t1 - t0, "steps": steps, "edges": int(edges)}

    def traced(self, n: int) -> Dict:
        def work():
            blocks, keys = [], []
            self._sink = lambda b, x: blocks.append(list(b))
            for _ in range(n):
                _, _, (hop_keys, _), _ = self.step()
                keys.append(hop_keys)
            self._sink = None
            return blocks, keys

        step_s, timed, gaps = trace.steady_seconds(self.step, warm=3, min_seconds=STEADY_S)
        red, (blocks, keys) = trace.traced(work)
        counts = [([int(b.seed_mask.sum()) for b in bs], [int(b.neigh_mask.sum()) for b in bs]) for bs in blocks]
        fam = ref_models.family(self.cfg["model"]["family"])
        return {"trace": red, "steady_step_s": step_s, "steady_steps": timed, "steady_step_ms": gaps, "steps": n, "cfg": self.cfg,
                "family": self.cfg["model"]["family"], "dims": fam.layer_dims(self.cfg),
                "heads": self.cfg["model"].get("heads", 1), "layer_counts": counts, "blocks": blocks, "hop_keys": keys, "fanout": self.fanout,
                "indptr": self.graph.indptr, "indices": self.graph.indices,
                "feature_row_bytes": self.inputs["features"][0].numel() * self.inputs["features"].element_size()}

    def free_program(self) -> None:
        self._hook.remove()
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ----------------------------------------------------

    def reference(self, q=ref_models.identity, compare: bool = True) -> Dict:
        """The reference over the check steps: ``{loss, g1, delta, logits}``,
        and with ``compare`` the counts of the program's block entries and
        rows that differ from it and the widest logit gap."""
        inp = self.inputs
        opt_cfg = self.cfg["model"]["optimizer"]
        opt = ref_models.Adam(self.weights, opt_cfg["lr"], opt_cfg["weight_decay"])
        params = {k: v.clone() for k, v in self.weights.items()}
        loss, g1, logits, gaps = [], {}, [], []
        blocks_diff = rows_diff = 0
        for t, st in enumerate(self.captured["steps"]):
            seeds, mask = st["seeds"], st["mask"]
            blocks = ref_sampler.sample_blocks(inp["indptr"], inp["indices"], seeds, mask,
                                               self.fanout, self.caps, st["hop_keys"])
            safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0).long()
            x = inp["features"][safe]
            if compare:
                blocks_diff += count_block_diffs(st["blocks"], blocks)
                got = st["feats"].to(self.device)
                live = blocks[-1].frontier_mask  # padding slots are masked wherever they are used
                rows_diff += int(((got != x).any(1) & live).sum()) if got.shape == x.shape else x.shape[0]
                del got
            labels = torch.where(mask, inp["labels"][torch.where(mask, seeds, 0).long()], 0)
            lval, grads, logits_r = ref_models.train_step(self.cfg, params, list(reversed(blocks)), x.float(),
                                                          labels, mask, st["drop_keys"], q)
            logits.append(logits_r)
            if compare:
                gaps.append(common.logit_gap(st["logits"].to(self.device), logits_r, mask))
            del x, blocks
            loss.append(lval)
            params = opt.step(params, grads)
            if t == 0:
                g1 = dict(opt.g)
        out = {"loss": loss, "g1": g1, "delta": {k: params[k] - self.weights[k] for k in params}, "logits": logits}
        if compare:
            out.update(blocks_differing=blocks_diff, rows_differing=rows_diff, logit_gap=max(gaps))
        return out

    def control_logit_gap(self, ctrl: Dict, ref: Dict) -> float:
        """The logit gap of ``ctrl``'s logits (a reference put in the
        program's place) from ``ref``'s, the worst step."""
        return max(common.logit_gap(c, r, st["mask"])
                   for c, r, st in zip(ctrl["logits"], ref["logits"], self.captured["steps"]))


BLOCK_FIELDS = ("frontier", "frontier_mask", "num_frontier", "neigh_slots", "neigh_mask")


def count_block_diffs(got: List[Dict], want: List) -> int:
    """Entries of the program's blocks (sampling order) that differ from
    the reference's; a block of another shape counts all its entries."""
    n = 0
    for g, w in zip(got, want):
        for f in BLOCK_FIELDS:
            a, b = g[f].to(w.frontier.device), getattr(w, f)
            if a.shape != b.shape:
                n += max(b.numel(), 1)
            else:
                n += int((a.to(b.dtype) != b).sum())
    return n + abs(len(got) - len(want))


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, trace_on: bool, device: torch.device,
        t_start: float) -> Dict:
    cell = TrainCell(cfg, traffic, seed, device, t_start=t_start)
    common.note("caps tuned", t_start)
    cell.build_program()
    cell.check_steps(int(traffic["check_steps"]))
    common.note("check steps done", t_start)
    cell.warm(int(traffic["warm_steps"]))
    common.note("set-up done", t_start)
    out: Dict = {"failed": 0}
    if trace_on:
        out["record"] = cell.traced(int(traffic["trace_steps"]))
        out["attempted"] = int(traffic["trace_steps"])
    else:
        w = cell.window(seconds)
        out["e2e"] = {"setup_s": w["t0"] - t_start, "train_edges_per_s": w["edges"] / w["window_s"]}
        out["attempted"] = w["steps"]
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cell.free_program()
    common.note("window closed", t_start)
    ref = cell.reference()
    common.note("reference done", t_start)
    prog = dict(cell.captured, **{k: ref[k] for k in common.COUNTED})
    out["checks"] = common.train_checks(prog, ref)
    return out
