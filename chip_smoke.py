#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dist_gnn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``dist_gnn_tpu_torch/csrc`` with nvcc,
then drives the port's SAGE serving path at the full width of the bench
config (GraphSAGE, 3 layers, in 100, hidden 256, 47 classes, bf16
compute; fanout (15, 10, 5), batch 512, dedup-free last hop; the
500k-node synthetic graph with ~30M edges, all in device memory; random
weights from a seed).  Phases, one JSON line each:

1. device: the card's name, count and power limit;
2. build: every kernel source compiled, one nvcc each, in parallel;
3. sampler: ``sample_blocks`` on CUDA and on the CPU with the same
   injected row keys gives bit-identical blocks (this holds the int64
   emulation of the uint32 PRNG on the card);
4. kernels: K1 (``gather_rows``) and K3 (``gather_mean``) held against
   their plain versions on the card at the main path's shapes, plus f32,
   an odd width and an empty input; times of the kernel, the plain
   version and the PyTorch library call, and the least time the card
   could take (bytes over 3.35 TB/s);
5. serving: ``Trainer.eval_step`` answers 8 batches of 512 validation
   seeds; one batch's logits are held against the plain path on the same
   blocks, and the launch counters show K1 once and K3 three times per
   request;
6. full-graph inference: ``full_graph_inference`` over all 500k nodes,
   timed, and held against the same function on the CPU on a 20k-node
   graph.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the script exits non-zero without the last line.
It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FAN_OUT = (15, 10, 5)
BATCH = 512
N_REQUESTS = 8
# bf16 tolerances, as a share of the reference's largest magnitude: K3
# sums in f32 and rounds once where the plain version rounds the sum and
# the quotient in bf16, so single elements differ by a bf16 ulp (2**-8
# relative) and the difference compounds through three layers.
K3_BF16_TOL = 1e-2
K3_F32_TOL = 1e-5
LOGITS_BF16_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def rel_err(out, ref) -> float:
    """max |out - ref| over max(1, max |ref|), in f32."""
    out, ref = out.float(), ref.float()
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return float((out - ref).abs().max()) / scale if ref.numel() else 0.0


def max_abs(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()) if ref.numel() else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.kernels import build
    from dist_gnn_tpu_torch.models.inference import full_graph_inference
    from dist_gnn_tpu_torch.models.sage import SAGE, contiguous_mean
    from dist_gnn_tpu_torch.ops import gather, prng, spmm
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks
    from dist_gnn_tpu_torch.training import Trainer
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    def device_ms(fn, kernel_name):
        """Mean device time of one launch of the named kernel while ``fn``
        runs, from the profiler; None when it recorded no such kernel."""
        kernels, _ = profile_device(fn)
        hits = [v for k, v in kernels.items() if kernel_name in k]
        return sum(ms for ms, _ in hits) / sum(n for _, n in hits) if hits else None

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = {"card": torch.cuda.get_device_name(0), "power": smi}
    emit({"phase": "device", "kind": card["card"], "count": torch.cuda.device_count(),
          "power": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": list(build.SOURCES),
          "ptxas": {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})

    # ---- data: the bench config's graph, features and model -------------
    t0 = time.perf_counter()
    arrays, meta = make_synthetic_dataset(
        num_nodes=500_000, avg_degree=30, feature_dim=100, num_classes=47,
        train_frac=0.2, seed=0,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    graph = hg.to_device(cuda)
    graph_cpu = hg.to_device("cpu")
    features = torch.from_numpy(arrays["features"]).to(cuda, torch.bfloat16)
    labels = torch.from_numpy(arrays["labels"]).to(cuda)
    model = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0), device=cuda)
    data_s = time.perf_counter() - t0

    # ---- 3. sampler: CUDA == CPU, bit for bit ----------------------------
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(cuda)
    mask = torch.ones(BATCH, dtype=torch.bool, device=cuda)
    key_gen = torch.Generator().manual_seed(1)
    hop_sizes = layer_capacities(BATCH, FAN_OUT)[: len(FAN_OUT)]
    hop_keys = [prng.random_keys(key_gen, (b,)) for b in hop_sizes]
    t0 = time.perf_counter()
    blocks, stats = sample_blocks(graph, seeds, mask, FAN_OUT, False,
                                  [k.to(cuda) for k in hop_keys], dedup_last=False)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    blocks_cpu, _ = sample_blocks(graph_cpu, seeds.cpu(), mask.cpu(), FAN_OUT, False,
                                  hop_keys, dedup_last=False)
    for i, (b, bc) in enumerate(zip(blocks, blocks_cpu)):
        for name in b._fields:
            check(torch.equal(getattr(b, name).cpu(), getattr(bc, name)),
                  f"sampler block {i} field {name} differs between CUDA and the CPU")
    check(int(stats["sampler_overflow"]) == 0, "sampler overflow")
    edges = [int(b.neigh_mask.sum()) for b in blocks]
    emit({"phase": "sampler", "bit_identical": True, "data_build_s": data_s,
          "num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
          "block_shapes": [list(b.neigh_slots.shape) for b in blocks],
          "valid_edges": edges, "first_call_s": sample_s})

    # ---- 4. K1 and K3 against their plain versions ------------------------
    safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0)
    L = safe.shape[0]
    out = gather.gather_rows(features, safe)
    ref = gather.gather_rows_plain(features, safe)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "K1 differs from table[idx] at the main-path shape")
    features32 = features.float()
    check(torch.equal(gather.gather_rows(features32, safe), features32[safe.long()]), "K1 f32")
    odd = torch.randn(1000, 37, device=cuda, dtype=torch.bfloat16)
    odd_idx = torch.randint(0, 1000, (777,), device=cuda, dtype=torch.int32)
    check(torch.equal(gather.gather_rows(odd, odd_idx), odd[odd_idx.long()]), "K1 odd F")
    check(gather.gather_rows(features, safe[:0]).shape == (0, 100), "K1 empty idx")
    row_bytes = 100 * features.element_size()
    k1_bytes = int(torch.unique(safe).numel()) * row_bytes + L * 4 + L * row_bytes
    k1 = {
        "name": "gather_rows", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
        "replaces": "dist_gnn_tpu/ops/gather_pallas.py:111",
        "max_abs_err": max_abs(out, ref),
        "ms": cuda_time_ms(lambda: gather.gather_rows(features, safe)),
        "plain_ms": cuda_time_ms(lambda: gather.gather_rows_plain(features, safe)),
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": cuda_time_ms(lambda: torch.index_select(features, 0, safe)),
    }
    emit({"phase": "kernel", "kernel": "K1 gather_rows", "shape": [hg.num_nodes, 100, L],
          "dtype": "bfloat16", "exact": True, "bytes": k1_bytes,
          "device_ms": device_ms(lambda: gather.gather_rows(features, safe), "gather_rows_kernel"),
          **k1, **card})

    # K3 at the three layers of one request: layer l aggregates over the
    # block that reversed(blocks)[l] names, from an h of that block's
    # frontier size (layer 0: the gathered features; deeper: hidden 256).
    hgen = torch.Generator(device=cuda).manual_seed(2)
    k3_layers = []
    k3_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    k3_err = 0.0
    for l, blk in enumerate(reversed(blocks)):
        S, kk = blk.neigh_slots.shape
        width = 100 if l == 0 else 256
        h = out if l == 0 else torch.randn(blk.num_src, width, device=cuda,
                                           generator=hgen).to(torch.bfloat16)
        slots, m = blk.neigh_slots, blk.neigh_mask
        got = gather.gather_mean(h, slots, m)
        want = spmm.gather_mean(h, slots, m)
        err = rel_err(got, want)
        check(err <= K3_BF16_TOL, f"K3 bf16 layer {l}: error {err} > {K3_BF16_TOL}")
        err32 = rel_err(gather.gather_mean(h.float(), slots, m), spmm.gather_mean(h.float(), slots, m))
        check(err32 <= K3_F32_TOL, f"K3 f32 layer {l}: error {err32} > {K3_F32_TOL}")
        k3_err = max(k3_err, max_abs(got, want))
        rows = int(torch.unique(slots[m]).numel())
        nbytes = rows * width * 2 + S * kk * 5 + S * width * 2
        table = torch.cat([h, torch.zeros(1, width, device=cuda, dtype=h.dtype)])
        bag = torch.where(m, slots, h.shape[0]).long()
        lay = {
            "layer": l, "S": S, "k": kk, "F": width, "cap": h.shape[0], "valid_slots": int(m.sum()),
            "distinct_rows": rows, "bytes": nbytes, "rel_err_bf16": err, "rel_err_f32": err32,
            "ms": cuda_time_ms(lambda: gather.gather_mean(h, slots, m)),
            "plain_ms": cuda_time_ms(lambda: spmm.gather_mean(h, slots, m)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "device_ms": device_ms(lambda: gather.gather_mean(h, slots, m), "gather_mean_kernel"),
            "library_ms": cuda_time_ms(lambda: F.embedding_bag(
                bag, table, mode="mean", padding_idx=h.shape[0])),
        }
        lay["library_max_abs_err"] = max_abs(
            F.embedding_bag(bag, table, mode="mean", padding_idx=h.shape[0]), got)
        for key in k3_sum:
            k3_sum[key] += lay[key]
        k3_layers.append(lay)
    odd_h = torch.randn(300, 37, device=cuda, dtype=torch.bfloat16)
    odd_s = torch.randint(0, 300, (50, 7), device=cuda, dtype=torch.int32)
    odd_m = torch.rand(50, 7, device=cuda) < 0.6
    odd_m[:2] = False
    odd_out = gather.gather_mean(odd_h, odd_s, odd_m)
    check(rel_err(odd_out, spmm.gather_mean(odd_h, odd_s, odd_m)) <= K3_BF16_TOL, "K3 odd F")
    check(bool((odd_out[:2] == 0).all()), "K3 all-masked rows must be 0")
    k3 = {
        "name": "gather_mean", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
        "replaces": "dist_gnn_tpu/ops/gather_pallas.py:279", "max_abs_err": k3_err,
        **k3_sum, "bound_by": "bytes",
    }
    emit({"phase": "kernel", "kernel": "K3 gather_mean", "dtype": "bfloat16",
          "times_are": "sums over the three layers of one request", "layers": k3_layers,
          **k3, **card})

    # ---- 5. serving: Trainer.eval_step ------------------------------------
    trainer = Trainer(model=model, fan_out=FAN_OUT, dedup_last=False, device=cuda)

    def plain_logits(blks, feats):
        """The serving forward with every kernel swapped for its plain
        version, on the same tensors."""
        h = feats
        for l, blk in enumerate(reversed(blks)):
            if l == 0:
                h_mean = contiguous_mean(h, blk)
            else:
                h_mean = spmm.gather_mean(h, blk.neigh_slots, blk.neigh_mask)
            h = model._layer_forward(model.layer_params(l), h[: blk.num_dst], h_mean).to(h.dtype)
            if l != len(FAN_OUT) - 1:
                h = torch.relu(h)
        return h

    with torch.inference_mode():
        logits = model(tuple(reversed(blocks)), gather.gather_rows(features, safe),
                       contiguous_first=True)
        logits_plain = plain_logits(blocks, gather.gather_rows_plain(features, safe))
    check(logits.shape == (BATCH, meta["num_classes"]), "logits shape")
    check(bool(torch.isfinite(logits.float()).all()), "logits must be finite")
    logits_err = rel_err(logits, logits_plain)
    check(logits_err <= LOGITS_BF16_TOL, f"serving logits vs plain path: {logits_err}")

    gen = SeedGenerator(arrays["valid_idx"][: N_REQUESTS * BATCH], BATCH, device=cuda)
    requests = [
        (s, mk, [prng.random_keys(key_gen, (b,), cuda) for b in hop_sizes])
        for s, mk in gen.epoch()
    ]
    trainer.eval_step(None, graph, features, labels, *requests[0])  # warm-up
    torch.cuda.synchronize()
    req_edges = 0
    for s, mk, keys in requests:
        blks, _ = sample_blocks(graph, s, mk, FAN_OUT, False, keys, dedup_last=False)
        req_edges += sum(int(b.neigh_mask.sum()) for b in blks)
    gather.gather_rows.launches = 0
    gather.gather_mean.launches = 0
    t0 = time.perf_counter()
    answers = [trainer.eval_step(None, graph, features, labels, *r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"gather_rows": gather.gather_rows.launches, "gather_mean": gather.gather_mean.launches}
    check(launches == {"gather_rows": N_REQUESTS, "gather_mean": 3 * N_REQUESTS},
          f"serving launches {launches}, expected 1 K1 and 3 K3 per request")
    correct = sum(int(c) for c, _ in answers)
    answered = sum(int(n) for _, n in answers)
    check(answered == N_REQUESTS * BATCH, "every seed answered")

    # where a request's time goes: each stage alone, host clock around a
    # synchronize; then the device's busy share under the profiler
    stage_s = {"sample": 0.0, "gather": 0.0, "forward": 0.0}
    for s, mk, keys in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blks, _ = sample_blocks(graph, s, mk, FAN_OUT, False, keys, dedup_last=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = gather.gather_rows(features, torch.where(blks[-1].frontier_mask, blks[-1].frontier, 0))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            model(tuple(reversed(blks)), feats, contiguous_first=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        stage_s["sample"] += t1 - t0
        stage_s["gather"] += t2 - t1
        stage_s["forward"] += t3 - t2
    prof_reqs = 4
    kernels, prof_wall = profile_device(
        lambda: trainer.eval_step(None, graph, features, labels, *requests[1]), iters=prof_reqs)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    emit({"phase": "serving", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / serve_s, "sampled_edges": req_edges,
          "logits_rel_err_vs_plain": logits_err, "correct": correct, "answered": answered,
          "launches": launches,
          "stage_ms_per_request": {k: v / N_REQUESTS * 1e3 for k, v in stage_s.items()},
          "profiled_ms_per_request": prof_wall / prof_reqs,
          "device_busy_share": busy_ms / prof_wall if kernels else None,
          "device_kernels_per_request": sum(n for _, n in kernels.values()) / prof_reqs,
          "top_kernels_ms_per_request": [[k[:80], ms / prof_reqs, n / prof_reqs] for k, (ms, n) in top],
          **card})
    k1["launches"] = launches["gather_rows"]
    k3["launches"] = launches["gather_mean"]

    # ---- 6. full-graph inference -----------------------------------------
    full_graph_inference(model, None, hg, features, device=cuda)  # warm-up
    torch.cuda.synchronize()
    gather.gather_rows.launches = 0
    gather.gather_mean.launches = 0
    t0 = time.perf_counter()
    out_full = full_graph_inference(model, None, hg, features, device=cuda)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_launches = {"gather_rows": gather.gather_rows.launches,
                     "gather_mean": gather.gather_mean.launches}
    check(out_full.shape == (hg.num_nodes, meta["num_classes"]), "full-graph output shape")
    check(bool(torch.isfinite(out_full.float()).all()), "full-graph output must be finite")
    check(full_launches["gather_rows"] > 0, "full-graph inference never launched K1")
    full_kernels, full_prof_ms = profile_device(
        lambda: full_graph_inference(model, None, hg, features, device=cuda), iters=1)
    full_top = sorted(full_kernels.items(), key=lambda kv: -kv[1][0])[:6]

    small, _ = make_synthetic_dataset(
        num_nodes=20_000, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=1,
    )
    shg = HostGraph(indptr=small["indptr"], indices=small["indices"])
    sfeat = torch.from_numpy(small["features"]).to(torch.bfloat16)
    model_cpu = SAGE(100, 256, 47, len(FAN_OUT), compute_dtype=torch.bfloat16, device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    got = full_graph_inference(model, None, shg, sfeat, device=cuda)
    want = full_graph_inference(model_cpu, None, shg, sfeat, device="cpu")
    small_err = rel_err(got.cpu(), want)
    check(small_err <= LOGITS_BF16_TOL, f"full-graph CUDA vs CPU at 20k nodes: {small_err}")
    emit({"phase": "full_graph_inference", "num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
          "seconds": full_s, "edges_per_s": len(FAN_OUT) * hg.num_edges / full_s,
          "launches": full_launches, "profiled_s": full_prof_ms / 1e3,
          "device_busy_share": sum(ms for ms, _ in full_kernels.values()) / full_prof_ms
          if full_kernels else None,
          "top_kernels_ms": [[k[:80], ms, n] for k, (ms, n) in full_top],
          "check_nodes": shg.num_nodes,
          "check_rel_err_vs_cpu": small_err, **card})

    # ---- 7. kernels, card, result -----------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern[k] for k in keys} for kern in (k1, k3)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
