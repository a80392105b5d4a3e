#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dist_gnn_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``dist_gnn_tpu_torch/csrc`` with nvcc,
then drives the port's serving and training paths at the full width of
the bench configs: GraphSAGE, 3 layers, in 100, hidden 256, 47 classes,
GAT(100, 128, 47, 3 layers, 4 heads) and GCN(100, 256, 47, 3 layers), all
bf16 compute with f32 params and dropout 0.5; fanout (15, 10, 5), batch
512, dedup-free last hop; Adam lr 1e-3 with coupled weight decay 5e-4; the
500k-node synthetic graph with ~30M edges, all in device memory; random
weights from a seed.  Phases, one JSON line each:

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
   K2 (``gather_rows_dma``) held equal to its plain version at the
   main-path shape, the gather bench's shape in bf16 and f32, an odd
   width, an L that is not a multiple of its rows per step and an empty
   input, plus the raise for a rows per step whose two stages exceed
   shared memory; its times beside K1's and ``index_select``'s;
   bench_gather: the gather bench entry point
   (``dist_gnn_tpu_torch.scripts.bench_gather2``), K2's path, one line
   per variant;
5. serving: ``Trainer.eval_step`` answers 8 batches of 512 validation
   seeds; one batch's logits are held against the plain path on the same
   blocks, and the launch counters show K1 once and K3 three times per
   request;
6. full-graph inference: ``full_graph_inference`` over all 500k nodes,
   timed, and held against the same function on the CPU on a 20k-node
   graph;
7. kernels: the K3 backward at SAGE layers 1 and 2, and K4 and K5 at the
   three GAT layers, held against their plain versions on the card in
   bf16, plus f32 and all-masked rows; times as in 4.
   Before K4/K5: each GAT layer's launch plan (rows, head split, shared
   memory, blocks per SM, waves) and the HMMA (tensor-core) instructions
   of every ``gat`` kernel in ``cuobjdump -sass`` of the built library
   (bf16 kernels must have some, the exact-f32 ones none); after them,
   both kernels in bf16 and f32 at edge shapes (S not a multiple of the
   row tile, E 37 and 1024, D 7 and 47, H 1 and 8, K 1 and 32, all-masked
   rows);
8. training_sage / training_gat: the loss and every parameter's gradient
   on one step's blocks against the same step with every kernel swapped
   for its plain version, in f32 and in bf16, then 8 ``Trainer.train_step`` calls timed, with
   the launch counters per step (SAGE: K1 1, K3 3, K3-bwd 2; GAT: K1 1,
   K4 3, K5 3), a stage breakdown and the device's busy share;
9. serving_gat: ``Trainer.eval_step`` with the GAT model, K4 three times
   per request, logits against the plain path;
10. training_gcn / serving_gcn: one GCN step's f32 loss and gradients
    against the same step on the CPU (same blocks and keys), then 8
    ``train_step`` calls and 8 ``eval_step`` requests, K1 once per step or
    request and no other kernel;
11. full_graph_inference_gat / full_graph_inference_gcn: as 6, for the
    trained GAT and GCN;
12. full_graph_inference_host: ``full_graph_inference_host`` (features
    and activations in host memory) for SAGE, GCN and GAT on the 20k-node
    graph, against the on-card ``full_graph_inference``, timed;
13. convergence: a fresh SAGE trained for 2 epochs over the training seeds
    (bench.py:399-441), then ``full_graph_inference`` and the validation
    accuracy, which must reach 0.99 (the pinned 1.0 less the margin).

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and last ``{"ok": true, "device": {...}}``.  Any
failed check raises, and the script exits non-zero without the last line.
It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
FAN_OUT = (15, 10, 5)
BATCH = 512
N_REQUESTS = 8
N_STEPS = 8
CONV_EPOCHS = 2  # bench.py:54
VAL_ACC_MIN = 1.0 - 0.01  # the pinned target less its margin (bench.py:52-53)
# bf16 tolerances, as a share of the reference's largest magnitude: K3
# sums in f32 and rounds once where the plain version rounds the sum and
# the quotient in bf16, so single elements differ by a bf16 ulp (2**-8
# relative) and the difference compounds through three layers.
K3_BF16_TOL = 1e-2
K3_F32_TOL = 1e-5
LOGITS_BF16_TOL = 5e-2
# K4 in bf16, as a share of the plain version's largest magnitude: both
# round alpha and agg to bf16, but from f32 sums taken in another order, so
# an element may land one bf16 ulp (2**-8) apart before the projection.
K4_BF16_TOL = 1e-2
# f32: the same arithmetic summed in another order.
K4_F32_TOL = 1e-5
# The K3 backward and K5 in f32: sums in another order, and the atomic adds
# (K3-bwd's rows, K5's dW across blocks) in an order that changes per run.
BWD_F32_TOL = 1e-4
# ... and on bf16 inputs: K5 rounds agg to bf16 before dW and writes dxn in
# bf16, the K3 backward casts its f32 sum to bf16, each from sums in
# another order than the plain version's.
BWD_BF16_TOL = 5e-2
# One training step's loss and gradients, kernels against the plain path.
# In f32 the two differ by summation order and atomics only: every
# gradient within GRAD_F32_TOL of the plain one's largest magnitude.  In
# bf16 the rounding alone moves single elements of this step's gradients
# by several percent of the largest (the phase prints the plain bf16
# path's distance from f32 beside the kernels'), so there the check is
# norm-wise: ||g - g_f32|| / ||g_f32|| within GRAD_BF16_TOL, which a
# missing or mis-scaled gradient path (an error of the order of the
# gradient itself) cannot meet.  The bf16 loss is held to LOGITS' limit.
LOSS_F32_TOL = 1e-5
GRAD_F32_TOL = 1e-3
GRAD_BF16_TOL = 0.2
# One GCN step in f32 on the card against the same step on the CPU: the
# same plain PyTorch ops (GCN has no kernel of its own; K1 is exact), so
# only summation order separates them.
CPU_F32_TOL = 1e-4
# The host-resident walk against the on-card walk, per family: SAGE's
# layers run in bf16 on both, from f32 sums taken in another order, so a
# logit may move by bf16 rounding (LOGITS_BF16_TOL); GCN's and GAT's walks
# run in f32 on both (h's dtype follows the f32 features), so only the
# summation order separates them.
HOST_TOL = {"sage": LOGITS_BF16_TOL, "gcn": 1e-4, "gat": 1e-4}
# The gather bench's shapes (scripts/bench_gather2.py:29-31).
BENCH_N, BENCH_F, BENCH_L = 500_000, 128, 540_672


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


def norm_err(out, ref) -> float:
    """||out - ref|| / ||ref|| in f32 (0 when both are all 0)."""
    den = float(ref.float().norm())
    num = float((out.float() - ref.float()).norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def share_err(out, ref) -> float:
    """max |out - ref| as a share of max |ref| (0 when both are all 0)."""
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    err = max_abs(out, ref)
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def hmma_counts(lib_path) -> dict:
    """HMMA (tensor-core mma) instructions per ``gat`` kernel in the SASS of
    the built library, by ``cuobjdump -sass``."""
    sass = subprocess.run(["cuobjdump", "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = next((k for k in ("gat_fwd_bf16", "gat_fwd_f32", "gat_bwd_bf16", "gat_bwd_f32",
                                    "gat_dw_bf16", "gat_dw_f32") if k in name), None)
            if cur is not None:
                cur += "_kernel" + ("<H=%s>" % name.split("ILi")[1][0] if "ILi" in name else "")
                counts[cur] = 0
        elif cur is not None and "HMMA" in line:
            counts[cur] += 1
    check(len(counts) >= 6, f"cuobjdump found {sorted(counts)}, expected every gat kernel")
    return counts


# K4/K5 edge shapes (K, S, E, H, D): S not a multiple of any row tile, E 37
# (odd, 2-byte rows) and 1024 (the envelope's edge), D 7 and 47 (heads that
# start off every vector boundary), H 1, 3 and 8, K 1 and 32.
GAT_EDGE_SHAPES = [(3, 1000, 37, 1, 7), (32, 333, 1024, 8, 47), (1, 77, 100, 8, 128),
                   (7, 129, 64, 3, 16), (5, 300, 37, 3, 7)]


def gat_edge_checks(gat_ops, gen) -> list:
    """K4 and K5 against their plain versions at GAT_EDGE_SHAPES in bf16
    and f32, need_dx True and False, with the first 3 rows all masked
    (their outputs and gradients must be exactly 0)."""
    import torch

    cuda = torch.device("cuda")
    rows = []
    for K, S, E, H, D in GAT_EDGE_SHAPES:
        for dt, tol4, tol5 in ((torch.bfloat16, K4_BF16_TOL, BWD_BF16_TOL), (torch.float32, K4_F32_TOL, BWD_F32_TOL)):
            x_n = torch.randn(K, S, E, device=cuda, generator=gen).to(dt)
            x_dst = torch.randn(S, E, device=cuda, generator=gen).to(dt)
            wal, war = ((torch.randn(E, H, device=cuda, generator=gen) * 0.1).to(dt) for _ in range(2))
            w = (torch.randn(E, H * D, device=cuda, generator=gen) * 0.1).to(dt)
            el = x_dst.float() @ wal.float()
            er3 = (x_n.reshape(K * S, E).float() @ war.float()).reshape(K, S, H)
            mask_f = (torch.rand(S, K, device=cuda, generator=gen) < 0.8).float()
            mask_f[:3] = 0
            g = torch.randn(S, H * D, device=cuda, generator=gen).to(dt)
            where = f"K={K} S={S} E={E} H={H} D={D} {dt}"
            out = gat_ops.gat_fwd(x_n, el, er3, mask_f, w, 0.2)
            e4 = share_err(out, gat_ops.gat_fwd_plain(x_n, el, er3, mask_f, w, 0.2))
            check(e4 <= tol4, f"K4 edge {where}: error {e4} > {tol4}")
            check(bool((out[:3] == 0).all()), f"K4 edge {where}: all-masked rows must be 0")
            e5 = {}
            for need_dx in (True, False):
                got = gat_ops.gat_bwd(x_n, el, er3, mask_f, w, g, 0.2, need_dx)
                want = gat_ops.gat_bwd_plain(x_n, el, er3, mask_f, w, g, 0.2, need_dx)
                for name, a, b in zip(("dw", "d_el", "d_er3", "dxn"), got, want):
                    if b is None:
                        check(a is None, f"K5 edge {where}: dxn without need_dx")
                        continue
                    e5[name] = max(e5.get(name, 0.0), share_err(a, b))
                    check(e5[name] <= tol5, f"K5 edge {where} {name}: error {e5[name]} > {tol5}")
                check(bool((got[1][:3] == 0).all() and (got[2][:, :3] == 0).all()),
                      f"K5 edge {where}: all-masked rows must have 0 score gradients")
                if need_dx:
                    check(bool((got[3][:, :3] == 0).all()), f"K5 edge {where}: all-masked rows' dxn must be 0")
            torch.cuda.synchronize()
            rows.append({"K": K, "S": S, "E": E, "H": H, "D": D, "dtype": str(dt), "err_k4": e4, "err_k5": e5})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    t_script = time.perf_counter()
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.kernels import build
    from dist_gnn_tpu_torch.models.gat import GAT
    from dist_gnn_tpu_torch.models.gcn import GCN
    from dist_gnn_tpu_torch.models.inference import full_graph_inference, full_graph_inference_host
    from dist_gnn_tpu_torch.models.sage import SAGE, contiguous_mean
    from dist_gnn_tpu_torch.ops import gat as gat_ops
    from dist_gnn_tpu_torch.ops import gather, prng, spmm
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks
    from dist_gnn_tpu_torch.scripts import bench_gather2
    from dist_gnn_tpu_torch.training import Trainer, masked_nll_loss
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    def device_ms(fn, kernel_name):
        """Mean device time of one launch of the named kernel while ``fn``
        runs, from the profiler; None when it recorded no such kernel."""
        kernels, _ = profile_device(fn)
        hits = [v for k, v in kernels.items() if kernel_name in k]
        return sum(ms for ms, _ in hits) / sum(n for _, n in hits) if hits else None

    counters = {"gather_rows": gather.gather_rows, "gather_rows_dma": gather.gather_rows_dma,
                "gather_mean": gather.gather_mean, "gather_mean_bwd": gather.gather_mean_bwd,
                "gat_fwd": gat_ops.gat_fwd, "gat_bwd": gat_ops.gat_bwd}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

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

    # ---- 4. K1, K2 and K3 against their plain versions --------------------
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

    # K2 at the main path's shape (K1's) and the gather bench's, beside K1
    # and index_select on the same inputs; bound = the distinct rows read
    # once, the ids, the output written once
    bgen = torch.Generator(device=cuda).manual_seed(7)
    bench_bf16 = torch.randn((BENCH_N, BENCH_F), generator=bgen, device=cuda).to(torch.bfloat16)
    bench_idx = torch.randint(0, BENCH_N, (BENCH_L,), generator=bgen, device=cuda, dtype=torch.int32)
    k2_shapes = {}
    for label, table, idx in (("main_path_bf16", features, safe), ("bench_bf16", bench_bf16, bench_idx),
                              ("bench_f32", bench_bf16.float(), bench_idx)):
        got = gather.gather_rows_dma(table, idx)
        check(torch.equal(got, gather.gather_rows_dma_plain(table, idx)), f"K2 differs from table[idx] at {label}")
        rb = table.shape[1] * table.element_size()
        uniq = int(torch.unique(idx).numel())
        nbytes = uniq * rb + idx.shape[0] * 4 + idx.shape[0] * rb
        k2_shapes[label] = {
            "N": table.shape[0], "F": table.shape[1], "L": idx.shape[0], "dtype": str(table.dtype),
            "rows_per_step": 128, "vec_bytes": gather._vec_bytes(rb, table, got), "unique_rows": uniq,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ms": cuda_time_ms(lambda: gather.gather_rows_dma(table, idx)),
            "device_ms": device_ms(lambda: gather.gather_rows_dma(table, idx), "gather_rows_dma_kernel"),
            "ms_rows_per_step_32": cuda_time_ms(lambda: gather.gather_rows_dma(table, idx, rows_per_step=32)),
            "plain_ms": cuda_time_ms(lambda: gather.gather_rows_dma_plain(table, idx)),
            "library_ms": cuda_time_ms(lambda: torch.index_select(table, 0, idx)),
            "k1_ms": cuda_time_ms(lambda: gather.gather_rows(table, idx)),
            "k1_device_ms": device_ms(lambda: gather.gather_rows(table, idx), "gather_rows_kernel"),
        }
        del got
    odd_got = gather.gather_rows_dma(odd, odd_idx)  # F = 37 bf16: 2-byte rows; L = 777, not a multiple of 128
    check(torch.equal(odd_got, odd[odd_idx.long()]), "K2 odd F and partial last tile")
    check(gather._vec_bytes(37 * 2, odd, odd_got) == 2, "K2 odd F should take 2-byte copies")
    before = gather.gather_rows_dma.launches
    check(gather.gather_rows_dma(features, safe[:0]).shape == (0, 100), "K2 empty idx")
    too_big = None
    try:
        gather.gather_rows_dma(torch.zeros((8, BENCH_F), device=cuda), bench_idx[:8], rows_per_step=512)
    except ValueError as e:
        too_big = str(e)
    check(too_big is not None, "K2 with rows_per_step 512 on 512-byte rows must raise")
    check(gather.gather_rows_dma.launches == before, "K2 launched for an empty idx or an oversized B")
    del bench_bf16, bench_idx
    prim = k2_shapes["bench_bf16"]
    k2 = {"name": "gather_rows_dma", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
          "replaces": "dist_gnn_tpu/ops/gather_pallas.py:211", "max_abs_err": 0.0,
          **{key: prim[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")}, "bound_by": "bytes"}
    emit({"phase": "kernel", "kernel": "K2 gather_rows_dma", "exact": True,
          "times_are": "the bench_bf16 shape; every shape in 'shapes'", "shapes": k2_shapes,
          "oversized_rows_per_step_raises": too_big, "smem_optin_bytes": gather.smem_optin_bytes(cuda),
          "library_is": "torch.index_select", **k2, **card})

    # ---- 4b. the gather bench entry point: K2's path ----------------------
    gather.gather_rows_dma.launches = 0
    t0 = time.perf_counter()
    bench_rows = bench_gather2.main(device=cuda)
    bench_s = time.perf_counter() - t0
    k2["launches"] = gather.gather_rows_dma.launches
    check(k2["launches"] > 0, "the gather bench never launched K2")
    check(any(not r["launched"] for r in bench_rows), "some rows_per_step should not fit in shared memory")
    emit({"phase": "bench_gather", "seconds": bench_s, "launches": {"gather_rows_dma": k2["launches"]},
          "variants": bench_rows, **card})

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

    def request_breakdown(m, tr):
        """Where a request's time goes: each stage alone (sample, gather,
        forward), host clock around a synchronize; then the device's busy
        share and top kernels under the profiler."""
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
                m(tuple(reversed(blks)), feats, contiguous_first=True)
            torch.cuda.synchronize()
            for key, dt in zip(stage_s, (t1 - t0, t2 - t1, time.perf_counter() - t2)):
                stage_s[key] += dt
        prof_reqs = 4
        kernels, prof_wall = profile_device(
            lambda: tr.eval_step(None, graph, features, labels, *requests[1]), iters=prof_reqs)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        return {"stage_ms_per_request": {k: v / N_REQUESTS * 1e3 for k, v in stage_s.items()},
                "profiled_ms_per_request": prof_wall / prof_reqs,
                "device_busy_share": sum(ms for ms, _ in kernels.values()) / prof_wall if kernels else None,
                "device_kernels_per_request": sum(n for _, n in kernels.values()) / prof_reqs,
                "top_kernels_ms_per_request": [[k[:80], ms / prof_reqs, n / prof_reqs]
                                               for k, (ms, n) in top]}

    emit({"phase": "serving", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / serve_s, "sampled_edges": req_edges,
          "logits_rel_err_vs_plain": logits_err, "correct": correct, "answered": answered,
          "launches": launches, **request_breakdown(model, trainer), **card})
    k1["launches"] = launches["gather_rows"]
    k3["launches"] = launches["gather_mean"]

    # ---- 6. full-graph inference -----------------------------------------
    small, _ = make_synthetic_dataset(
        num_nodes=20_000, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=1,
    )
    shg = HostGraph(indptr=small["indptr"], indices=small["indices"])
    sfeat = torch.from_numpy(small["features"]).to(torch.bfloat16)

    def full_graph_phase(name, m):
        """``full_graph_inference`` of ``m`` over the 500k-node graph, timed
        warm with its launches counted (K1 and nothing else), then held
        against the same function on the CPU on the 20k-node graph."""
        full_graph_inference(m, None, hg, features, device=cuda)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out_full = full_graph_inference(m, None, hg, features, device=cuda)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        full_launches = read_counts()
        check(out_full.shape == (hg.num_nodes, meta["num_classes"]), f"{name}: output shape")
        check(bool(torch.isfinite(out_full.float()).all()), f"{name}: output must be finite")
        check(full_launches["gather_rows"] > 0 and sum(full_launches.values()) == full_launches["gather_rows"],
              f"{name}: launches {full_launches}, expected K1 and no other kernel")
        del out_full
        full_kernels, full_prof_ms = profile_device(
            lambda: full_graph_inference(m, None, hg, features, device=cuda), iters=1)
        full_top = sorted(full_kernels.items(), key=lambda kv: -kv[1][0])[:6]
        got = full_graph_inference(m, None, shg, sfeat, device=cuda)
        want = full_graph_inference(copy.deepcopy(m).to("cpu"), None, shg, sfeat, device="cpu")
        small_err = rel_err(got.cpu(), want)
        check(small_err <= LOGITS_BF16_TOL, f"{name}: CUDA vs CPU at 20k nodes: {small_err}")
        emit({"phase": name, "num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
              "seconds": full_s, "edges_per_s": len(FAN_OUT) * hg.num_edges / full_s,
              "launches": full_launches, "profiled_s": full_prof_ms / 1e3,
              "device_busy_share": sum(ms for ms, _ in full_kernels.values()) / full_prof_ms
              if full_kernels else None,
              "top_kernels_ms": [[k[:80], ms, n] for k, (ms, n) in full_top],
              "check_nodes": shg.num_nodes,
              "check_rel_err_vs_cpu": small_err, **card})

    full_graph_phase("full_graph_inference", model)

    # ---- 7. K3 backward, K4 and K5 against their plain versions ---------
    def call_device_ms(fn, names, iters=10):
        """Device ms per call of ``fn`` in the kernels whose names contain
        one of ``names``, from the profiler; None if it recorded none."""
        kernels, _ = profile_device(fn, iters=iters)
        hits = [ms for k, (ms, _) in kernels.items() if any(n in k for n in names)]
        return sum(hits) / iters if hits else None

    kgen = torch.Generator(device=cuda).manual_seed(3)
    sage_blocks = list(reversed(blocks))  # input-first, as the model sees them

    # K3 backward where a SAGE step runs it: layers 1 and 2 (layer 0's
    # input, the gathered features, needs no gradient)
    k3b_layers, k3b_err = [], 0.0
    k3b_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for l in (1, 2):
        blk = sage_blocks[l]
        S, kk = blk.neigh_slots.shape
        cap, width = blk.num_src, 256
        d_out = torch.randn(S, width, device=cuda, generator=kgen).to(torch.bfloat16)
        slots, m = blk.neigh_slots, blk.neigh_mask
        got = gather.gather_mean_bwd(d_out, slots, m, cap)
        want = gather.gather_mean_bwd_plain(d_out, slots, m, cap)
        err = share_err(got, want)
        check(err <= BWD_BF16_TOL, f"K3-bwd bf16 layer {l}: error {err} > {BWD_BF16_TOL}")
        err32 = share_err(gather.gather_mean_bwd(d_out.float(), slots, m, cap),
                          gather.gather_mean_bwd_plain(d_out.float(), slots, m, cap))
        check(err32 <= BWD_F32_TOL, f"K3-bwd f32 layer {l}: error {err32} > {BWD_F32_TOL}")
        k3b_err = max(k3b_err, max_abs(got, want))
        # d_out, slots and mask read once, the [cap, F] gradient written once
        nbytes = S * width * 2 + S * kk * 5 + cap * width * 2
        table = torch.zeros(cap + 1, width, device=cuda, dtype=torch.bfloat16, requires_grad=True)
        bag = torch.where(m, slots, cap).long()
        bag_out = F.embedding_bag(bag, table, mode="mean", padding_idx=cap)
        lay = {
            "layer": l, "S": S, "k": kk, "F": width, "cap": cap, "valid_slots": int(m.sum()),
            "bytes": nbytes, "err_bf16": err, "err_f32": err32,
            "ms": cuda_time_ms(lambda: gather.gather_mean_bwd(d_out, slots, m, cap)),
            "plain_ms": cuda_time_ms(lambda: gather.gather_mean_bwd_plain(d_out, slots, m, cap)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "device_ms": call_device_ms(lambda: gather.gather_mean_bwd(d_out, slots, m, cap),
                                        ["gather_mean_bwd_kernel"]),
            "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
                bag_out, table, d_out, retain_graph=True)),
        }
        for key in k3b_sum:
            k3b_sum[key] += lay[key]
        k3b_layers.append(lay)
    odd_d = torch.randn(50, 37, device=cuda, generator=kgen).to(torch.bfloat16)
    odd_s = torch.randint(0, 300, (50, 7), device=cuda, dtype=torch.int32, generator=kgen)
    odd_m = torch.rand(50, 7, device=cuda, generator=kgen) < 0.6
    odd_m[:2] = False
    odd_got = gather.gather_mean_bwd(odd_d, odd_s, odd_m, 300)
    check(share_err(odd_got, gather.gather_mean_bwd_plain(odd_d, odd_s, odd_m, 300)) <= BWD_BF16_TOL,
          "K3-bwd odd F")
    k3b = {
        "name": "gather_mean_bwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
        "replaces": "dist_gnn_tpu/ops/gather_pallas.py:279", "max_abs_err": k3b_err,
        **k3b_sum, "bound_by": "bytes",
    }
    emit({"phase": "kernel", "kernel": "K3-bwd gather_mean_bwd", "dtype": "bfloat16",
          "replaces_note": "the backward of K3; the JAX package differentiates its jnp mean "
                           "through XLA and has no Pallas backward",
          "times_are": "sums over SAGE layers 1 and 2 of one step", "layers": k3b_layers,
          "library_is": "backward of F.embedding_bag(mode='mean')", **k3b, **card})

    # K4 and K5 at the three layers of the GAT bench config on one request's
    # blocks: layer 0 reads the gathered features as a free k-major reshape,
    # deeper layers a k-major gather of a random hidden [num_src, 512]
    H = 4
    gat_dims = [(100, 128), (512, 128), (512, meta["num_classes"])]
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    gat_plans = []
    for l, blk in enumerate(sage_blocks):
        S, kk = blk.neigh_slots.shape
        E, D = gat_dims[l]
        for kern in ("fwd", "bwd"):
            p = gat_ops.gat_plan(kern, kk, S, E, H, D, torch.bfloat16, num_sms)
            gat_plans.append({"layer": l, "kernel": "K4" if kern == "fwd" else "K5", "S": S, "K": kk,
                              "E": E, "D": D, "rows": p.rows,
                              "heads_per_block": p.heads_per_block, "grid": list(p.grid),
                              "smem_bytes": p.smem_bytes, "blocks_per_sm": p.blocks_per_sm,
                              "waves": p.waves, "w_rows": p.w_rows, "dw_splits": p.dw_splits})
    hmma = hmma_counts(build._lib_path("gat"))
    for name, n in hmma.items():
        want_tc = "bf16" in name
        check((n > 0) == want_tc, f"{name}: {n} HMMA instructions, expected {'some' if want_tc else 'none'}")
    emit({"phase": "gat_plan", "num_sms": num_sms, "layers": gat_plans,
          "hmma_per_kernel": hmma, "hmma_from": "cuobjdump -sass of the built libgat", **card})
    k4_layers, k5_layers = [], []
    k4_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    k5_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    k4_err = k5_err = 0.0
    k4_flop_bound = k5_flop_bound = True
    for l, blk in enumerate(sage_blocks):
        S, kk = blk.neigh_slots.shape
        E, D = gat_dims[l]
        if l == 0:
            x_dst, x_n = out[:S], out[S:].reshape(kk, S, E)
        else:
            h = torch.randn(blk.num_src, E, device=cuda, generator=kgen).to(torch.bfloat16)
            safe_l = torch.where(blk.neigh_mask, blk.neigh_slots, 0)
            x_dst, x_n = h[:S], h[safe_l.T.long()].contiguous()
        wal = (torch.randn(E, H, device=cuda, generator=kgen) * 0.1).to(torch.bfloat16)
        war = (torch.randn(E, H, device=cuda, generator=kgen) * 0.1).to(torch.bfloat16)
        w = (torch.randn(E, H * D, device=cuda, generator=kgen) * 0.1).to(torch.bfloat16)
        el = x_dst.float() @ wal.float()
        er3 = (x_n.reshape(kk * S, E).float() @ war.float()).reshape(kk, S, H)
        mask_f = blk.neigh_mask.float()
        g = torch.randn(S, H * D, device=cuda, generator=kgen).to(torch.bfloat16)
        need_dx = l > 0  # as in a training step
        fwd_args = (x_n, el, er3, mask_f, w, 0.2)
        bwd_args = (x_n, el, er3, mask_f, w, g, 0.2, need_dx)
        got = gat_ops.gat_fwd(*fwd_args)
        want = gat_ops.gat_fwd_plain(*fwd_args)
        err4 = share_err(got, want)
        check(err4 <= K4_BF16_TOL, f"K4 bf16 layer {l}: error {err4} > {K4_BF16_TOL}")
        k4_err = max(k4_err, max_abs(got, want))
        gotb = gat_ops.gat_bwd(*bwd_args)
        wantb = gat_ops.gat_bwd_plain(*bwd_args)
        err5 = {}
        for name, a, b in zip(("dw", "d_el", "d_er3", "dxn"), gotb, wantb):
            check((a is None) == (b is None) == (name == "dxn" and not need_dx), f"K5 {name} presence")
            if a is None:
                continue
            err5[name] = share_err(a, b)
            check(err5[name] <= BWD_BF16_TOL, f"K5 bf16 layer {l} {name}: error {err5[name]}")
            k5_err = max(k5_err, max_abs(a, b))
        if l == 1:  # f32 at one shape
            f32_args = (x_n.float(), el, er3, mask_f, w.float(), 0.2)
            e32 = share_err(gat_ops.gat_fwd(*f32_args), gat_ops.gat_fwd_plain(*f32_args))
            check(e32 <= K4_F32_TOL, f"K4 f32 layer 1: error {e32} > {K4_F32_TOL}")
            b32 = f32_args[:5] + (g.float(), 0.2, True)
            for name, a, b in zip(("dw", "d_el", "d_er3", "dxn"), gat_ops.gat_bwd(*b32),
                                  gat_ops.gat_bwd_plain(*b32)):
                e = share_err(a, b)
                check(e <= BWD_F32_TOL, f"K5 f32 layer 1 {name}: error {e} > {BWD_F32_TOL}")
        if l == 2:  # rows with every slot masked give exactly 0
            holes = mask_f.clone()
            holes[:3] = 0
            o = gat_ops.gat_fwd(x_n, el, er3, holes, w, 0.2)
            check(bool((o[:3] == 0).all()), "K4 all-masked rows must be 0")
            hb = gat_ops.gat_bwd(x_n, el, er3, holes, w, g, 0.2, True)
            check(bool((hb[1][:3] == 0).all() and (hb[3][:, :3] == 0).all()),
                  "K5 all-masked rows must have 0 gradients")
        HD = H * D
        in_bytes = kk * S * E * 2 + S * H * 4 + kk * S * H * 4 + S * kk * 4 + E * HD * 2
        b4 = in_bytes + S * HD * 2
        f4 = 2 * kk * S * E * H + 2 * S * E * HD
        b5 = in_bytes + S * HD * 2 + E * HD * 4 + S * H * 4 + kk * S * H * 4 \
            + (kk * S * E * 2 if need_dx else 0)
        f5 = 2 * S * HD * E * 2 + 2 * kk * S * E * H * (3 if need_dx else 2)
        bound4 = max(b4 / HBM_BYTES_PER_S, f4 / BF16_FLOPS) * 1e3
        bound5 = max(b5 / HBM_BYTES_PER_S, f5 / BF16_FLOPS) * 1e3
        k4_flop_bound &= f4 / BF16_FLOPS > b4 / HBM_BYTES_PER_S
        k5_flop_bound &= f5 / BF16_FLOPS > b5 / HBM_BYTES_PER_S
        shape = {"layer": l, "K": kk, "S": S, "E": E, "H": H, "D": D}
        lay4 = {**shape, "bytes": b4, "flops": f4, "err_bf16": err4,
                "ms": cuda_time_ms(lambda: gat_ops.gat_fwd(*fwd_args)),
                "plain_ms": cuda_time_ms(lambda: gat_ops.gat_fwd_plain(*fwd_args), iters=5),
                "bound_ms": bound4,
                "device_ms": call_device_ms(lambda: gat_ops.gat_fwd(*fwd_args), ["gat_fwd_"])}
        lay5 = {**shape, "need_dx": need_dx, "bytes": b5, "flops": f5, "err_bf16": err5,
                "ms": cuda_time_ms(lambda: gat_ops.gat_bwd(*bwd_args)),
                "plain_ms": cuda_time_ms(lambda: gat_ops.gat_bwd_plain(*bwd_args), iters=5),
                "bound_ms": bound5,
                "device_ms": call_device_ms(lambda: gat_ops.gat_bwd(*bwd_args), ["gat_bwd_", "gat_dw_"]),
                "device_ms_rows_kernel": call_device_ms(lambda: gat_ops.gat_bwd(*bwd_args), ["gat_bwd_"]),
                "device_ms_dw_kernel": call_device_ms(lambda: gat_ops.gat_bwd(*bwd_args), ["gat_dw_"])}
        for acc, lay in ((k4_sum, lay4), (k5_sum, lay5)):
            for key in acc:
                acc[key] += lay[key]
        k4_layers.append(lay4)
        k5_layers.append(lay5)
    gat_edges = gat_edge_checks(gat_ops, kgen)
    no_library = "none: no one PyTorch call computes the fused softmax-aggregate-project"
    k4 = {"name": "gat_fwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gat.cu",
          "replaces": "dist_gnn_tpu/ops/gat_pallas.py:206", "max_abs_err": k4_err, **k4_sum,
          "bound_by": "operations" if k4_flop_bound else "bytes", "library_ms": None}
    k5 = {"name": "gat_bwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gat.cu",
          "replaces": "dist_gnn_tpu/ops/gat_pallas.py:230", "max_abs_err": k5_err, **k5_sum,
          "bound_by": "operations" if k5_flop_bound else "bytes", "library_ms": None}
    emit({"phase": "kernel", "kernel": "K4 gat_fwd", "dtype": "bfloat16", "library": no_library,
          "times_are": "sums over the three GAT layers of one step", "layers": k4_layers,
          "edge_shapes": gat_edges, **k4, **card})
    emit({"phase": "kernel", "kernel": "K5 gat_bwd", "dtype": "bfloat16", "library": no_library,
          "times_are": "sums over the three GAT layers of one step (need_dx on layers 1, 2)",
          "layers": k5_layers, **k5, **card})

    # ---- 8. training: gradients against the plain path, then 8 steps -----
    @contextlib.contextmanager
    def plain_kernels():
        """Every kernel on the training path swapped for its plain version,
        on the same CUDA tensors (a check of the kernels, not a mode of the
        port)."""
        swaps = [(gather, "_gather_mean_fwd", spmm.gather_mean),
                 (gather, "gather_mean_bwd", gather.gather_mean_bwd_plain),
                 (gat_ops, "gat_fwd", gat_ops.gat_fwd_plain),
                 (gat_ops, "gat_bwd", gat_ops.gat_bwd_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        try:
            for mod, name, fn in swaps:
                setattr(mod, name, fn)
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def loss_and_grads(m, blks, feats, labs, smask, drop_keys):
        m.zero_grad(set_to_none=True)
        loss, _ = masked_nll_loss(m, False, blks, feats, labs, smask, drop_keys)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad.detach().clone() for n, p in m.named_parameters()}

    def safe_ids(blks):
        return torch.where(blks[-1].frontier_mask, blks[-1].frontier, 0)

    train_batches = list(itertools.islice(
        SeedGenerator(arrays["train_idx"], BATCH, shuffle=True, drop_last=True, device=cuda)
        .epoch(torch.Generator(device=cuda).manual_seed(100)), N_STEPS + 1))

    features32 = features.float()

    def kernel_grad_check(name, m, m32, blks, labs, mk0, drop):
        """One step's loss and gradients, kernels against their plain
        versions: in f32 (``m32``, an f32 copy of ``m``), where they must
        agree to rounding, and in bf16 against the f32 gradients,
        norm-wise (see GRAD_BF16_TOL)."""
        res = {}
        for tag, mm, feat_store in (("f32", m32, features32), ("bf16", m, features)):
            feats = gather.gather_rows(feat_store, safe_ids(blks))
            reset_counts()
            res[tag] = loss_and_grads(mm, blks, feats, labs, mk0, drop)
            kernel_counts = read_counts()
            with plain_kernels():
                res[tag + "_plain"] = loss_and_grads(mm, blks, feats, labs, mk0, drop)
            check(read_counts() == kernel_counts, f"{name}: the plain path launched a kernel")
            check(kernel_counts["gather_mean_bwd"] + kernel_counts["gat_bwd"] > 0,
                  f"{name}: no backward kernel ran")
        losses_chk = {tag: float(res[tag][0]) for tag in res}
        check(all(v == v and abs(v) < float("inf") for v in losses_chk.values()), f"{name}: loss not finite")
        check(abs(losses_chk["f32"] - losses_chk["f32_plain"]) <= LOSS_F32_TOL * abs(losses_chk["f32_plain"]),
              f"{name}: f32 loss {losses_chk}")
        check(abs(losses_chk["bf16"] - losses_chk["bf16_plain"]) <= LOGITS_BF16_TOL * abs(losses_chk["bf16_plain"]),
              f"{name}: bf16 loss {losses_chk}")
        g32, g32p, g16, g16p = (res[t][1] for t in ("f32", "f32_plain", "bf16", "bf16_plain"))
        grad_err = {n: {"f32_kernel_vs_plain": share_err(g32[n], g32p[n]),
                        "bf16_kernel_vs_f32_norm": norm_err(g16[n], g32p[n]),
                        "bf16_plain_vs_f32_norm": norm_err(g16p[n], g32p[n]),
                        "bf16_kernel_vs_f32_share": share_err(g16[n], g32p[n]),
                        "bf16_plain_vs_f32_share": share_err(g16p[n], g32p[n])} for n in g32p}
        bad = {n: e for n, e in grad_err.items()
               if not (e["f32_kernel_vs_plain"] <= GRAD_F32_TOL
                       and e["bf16_kernel_vs_f32_norm"] <= GRAD_BF16_TOL)}
        check(not bad, f"{name}: gradients off the plain path: {bad}")
        return {"loss_kernel_and_plain": losses_chk, "grad_share_err": grad_err}

    def cpu_grad_check(name, m32, blks, labs, mk0, drop):
        """One step's f32 loss and gradients on the card against the same
        step on the CPU, on the same blocks, features and dropout keys."""
        feats = gather.gather_rows(features32, safe_ids(blks))
        loss, grads = loss_and_grads(m32, blks, feats, labs, mk0, drop)
        m_cpu = copy.deepcopy(m32).to("cpu")
        blks_cpu = [type(b)(*(x.cpu() for x in b)) for b in blks]
        loss_cpu, grads_cpu = loss_and_grads(m_cpu, blks_cpu, feats.cpu(), labs.cpu(), mk0.cpu(),
                                             [d.cpu() for d in drop])
        loss_err = abs(float(loss) - float(loss_cpu)) / max(abs(float(loss_cpu)), 1.0)
        grad_err = {n: share_err(grads[n].cpu(), grads_cpu[n]) for n in grads_cpu}
        check(loss_err <= CPU_F32_TOL, f"{name}: f32 loss {float(loss)} vs CPU {float(loss_cpu)}")
        bad = {n: e for n, e in grad_err.items() if not e <= CPU_F32_TOL}
        check(not bad, f"{name}: f32 gradients off the CPU's: {bad}")
        return {"f32_loss_cuda_and_cpu": [float(loss), float(loss_cpu)], "f32_loss_err_vs_cpu": loss_err,
                "f32_grad_share_err_vs_cpu": grad_err}

    def train_phase(name, m, per_step, seed, grad_check):
        """One step's gradients checked by ``grad_check(blocks, labels,
        seed mask, dropout keys)``, then 8 timed ``train_step`` calls of
        ``m`` with their launch counts, stage breakdown and busy share."""
        tr = Trainer(model=m, fan_out=FAN_OUT, dedup_last=False, device=cuda)
        tgen = torch.Generator(device=cuda).manual_seed(seed)
        s0, mk0 = train_batches[0]
        blks, _ = sample_blocks(graph, s0, mk0, FAN_OUT, False, tgen, dedup_last=False)
        labs = torch.where(mk0, labels[torch.where(mk0, s0, 0).long()], 0)
        drop = [prng.random_keys(tgen, (b.num_dst,), cuda) for b in list(reversed(blks))[:-1]]
        checked = grad_check(blks, labs, mk0, drop)

        tr.train_step(graph, features, labels, s0, mk0, tgen)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mets = [tr.train_step(graph, features, labels, s, mk, tgen) for s, mk in train_batches[1:]]
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / N_STEPS
        launches = read_counts()
        want = {k: v * N_STEPS for k, v in per_step.items()}
        check(launches == want, f"{name}: launches {launches}, expected {want}")
        losses = [float(mt["loss"]) for mt in mets]
        check(all(map(lambda v: v == v and abs(v) < float("inf"), losses)), f"{name}: loss not finite")
        check(all(int(mt["sampler_overflow"]) == 0 for mt in mets), f"{name}: sampler overflow")
        # trained edges per step (bench.py:290-295): valid sampled slots of
        # the same seeds, sampled again with other keys
        egen = torch.Generator(device=cuda).manual_seed(seed + 1)
        edges = sum(int(b.neigh_mask.sum())
                    for s, mk in train_batches[1:]
                    for b in sample_blocks(graph, s, mk, FAN_OUT, False, egen, dedup_last=False)[0])
        edges /= N_STEPS
        # where a step's time goes: each stage alone, synchronised
        stage = {"sample": 0.0, "gather": 0.0, "forward": 0.0, "backward": 0.0, "adam": 0.0}
        for s, mk in train_batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bl, _ = sample_blocks(graph, s, mk, FAN_OUT, False, tgen, dedup_last=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ft = gather.gather_rows(features, safe_ids(bl))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            lb = torch.where(mk, labels[torch.where(mk, s, 0).long()], 0)
            loss, _ = masked_nll_loss(m, False, bl, ft, lb, mk, tgen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            tr.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            tr.optimizer.step()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for key, dt in zip(stage, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                stage[key] += dt
        prof_steps = 3
        s1, mk1 = train_batches[1]
        kern, prof_wall = profile_device(
            lambda: tr.train_step(graph, features, labels, s1, mk1, tgen), iters=prof_steps)
        busy = sum(ms for ms, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
        emit({"phase": name, "steps": N_STEPS, "batch": BATCH, "ms_per_step": step_s * 1e3,
              "trained_edges_per_s": edges / step_s, "valid_edges_per_step": edges,
              "losses": losses, "launches": launches,
              "launches_per_step": {k: v / N_STEPS for k, v in launches.items()}, **checked,
              "stage_ms_per_step": {k: v / N_STEPS * 1e3 for k, v in stage.items()},
              "profiled_ms_per_step": prof_wall / prof_steps,
              "device_busy_share": busy / prof_wall if kern else None,
              "device_kernels_per_step": sum(n for _, n in kern.values()) / prof_steps,
              "top_kernels_ms_per_step": [[k[:80], ms / prof_steps, n / prof_steps]
                                          for k, (ms, n) in top], **card})
        return tr, launches

    sage_train = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(4), device=cuda)
    sage32 = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), device=cuda)
    sage32.load_state_dict(sage_train.state_dict())
    _, sage_launches = train_phase(
        "training_sage", sage_train,
        {"gather_rows": 1, "gather_rows_dma": 0, "gather_mean": 3, "gather_mean_bwd": 2,
         "gat_fwd": 0, "gat_bwd": 0}, 20,
        lambda *a: kernel_grad_check("training_sage", sage_train, sage32, *a))
    k3b["launches"] = sage_launches["gather_mean_bwd"]
    gat_model = GAT(100, 128, meta["num_classes"], len(FAN_OUT), num_heads=4,
                    compute_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(5),
                    device=cuda)
    gat32 = GAT(100, 128, meta["num_classes"], len(FAN_OUT), num_heads=4, device=cuda)
    gat32.load_state_dict(gat_model.state_dict())
    gat_trainer, gat_launches = train_phase(
        "training_gat", gat_model,
        {"gather_rows": 1, "gather_rows_dma": 0, "gather_mean": 0, "gather_mean_bwd": 0,
         "gat_fwd": 3, "gat_bwd": 3}, 30,
        lambda *a: kernel_grad_check("training_gat", gat_model, gat32, *a))
    k4["launches"] = gat_launches["gat_fwd"]
    k5["launches"] = gat_launches["gat_bwd"]

    # ---- 9. serving the GAT model ------------------------------------------
    with torch.inference_mode():
        g_logits = gat_model(tuple(reversed(blocks)), gather.gather_rows(features, safe),
                             contiguous_first=True)
        with plain_kernels():
            g_plain = gat_model(tuple(reversed(blocks)), gather.gather_rows_plain(features, safe),
                                contiguous_first=True)
    g_err = rel_err(g_logits, g_plain)
    check(g_logits.shape == (BATCH, meta["num_classes"]) and bool(torch.isfinite(g_logits.float()).all()),
          "GAT logits shape or values")
    check(g_err <= LOGITS_BF16_TOL, f"GAT serving logits vs plain path: {g_err}")
    gat_trainer.eval_step(None, graph, features, labels, *requests[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    g_answers = [gat_trainer.eval_step(None, graph, features, labels, *r) for r in requests]
    torch.cuda.synchronize()
    g_serve_s = time.perf_counter() - t0
    g_launches = read_counts()
    want = {"gather_rows": N_REQUESTS, "gather_rows_dma": 0, "gather_mean": 0, "gather_mean_bwd": 0,
            "gat_fwd": 3 * N_REQUESTS, "gat_bwd": 0}
    check(g_launches == want, f"GAT serving launches {g_launches}, expected {want}")
    check(sum(int(n) for _, n in g_answers) == N_REQUESTS * BATCH, "every seed answered (GAT)")
    emit({"phase": "serving_gat", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": g_serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / g_serve_s, "launches": g_launches,
          "logits_rel_err_vs_plain": g_err,
          "correct": sum(int(c) for c, _ in g_answers), **card})

    # ---- 10. GCN: training and serving ------------------------------------
    k1_only = {"gather_rows": 1, "gather_rows_dma": 0, "gather_mean": 0, "gather_mean_bwd": 0,
               "gat_fwd": 0, "gat_bwd": 0}
    gcn_model = GCN(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(8), device=cuda)
    gcn32 = GCN(100, 256, meta["num_classes"], len(FAN_OUT), device=cuda)
    gcn32.load_state_dict(gcn_model.state_dict())
    gcn_trainer, _ = train_phase("training_gcn", gcn_model, k1_only, 40,
                                 lambda *a: cpu_grad_check("training_gcn", gcn32, *a))

    gcn_cpu = copy.deepcopy(gcn_model).to("cpu")
    with torch.inference_mode():  # one request's logits, the card against the CPU
        c_logits = gcn_model(tuple(reversed(blocks)), gather.gather_rows(features, safe),
                             contiguous_first=True)
        c_cpu = gcn_cpu(tuple(reversed(blocks_cpu)), features.cpu()[safe.cpu().long()],
                        contiguous_first=True)
    c_err = rel_err(c_logits.cpu(), c_cpu)
    check(c_logits.shape == (BATCH, meta["num_classes"]) and bool(torch.isfinite(c_logits.float()).all()),
          "GCN logits shape or values")
    check(c_err <= LOGITS_BF16_TOL, f"GCN serving logits vs the CPU: {c_err}")
    gcn_trainer.eval_step(None, graph, features, labels, *requests[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    c_answers = [gcn_trainer.eval_step(None, graph, features, labels, *r) for r in requests]
    torch.cuda.synchronize()
    c_serve_s = time.perf_counter() - t0
    c_launches = read_counts()
    want = {k: v * N_REQUESTS for k, v in k1_only.items()}
    check(c_launches == want, f"GCN serving launches {c_launches}, expected {want}")
    check(sum(int(n) for _, n in c_answers) == N_REQUESTS * BATCH, "every seed answered (GCN)")
    emit({"phase": "serving_gcn", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": c_serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / c_serve_s, "launches": c_launches,
          "logits_rel_err_vs_cpu": c_err, "correct": sum(int(c) for c, _ in c_answers),
          **request_breakdown(gcn_model, gcn_trainer), **card})

    # ---- 11. full-graph inference of GAT and GCN ---------------------------
    full_graph_phase("full_graph_inference_gat", gat_model)
    full_graph_phase("full_graph_inference_gcn", gcn_model)

    # ---- 12. host-resident full-graph inference (20k nodes) ----------------
    host_feats = small["features"]  # f32 numpy, host memory
    host_rows = {}
    for tag, m in (("sage", model), ("gcn", gcn_model), ("gat", gat_model)):
        want_h = full_graph_inference(m, None, shg, torch.from_numpy(host_feats), device=cuda)
        full_graph_inference_host(m, None, shg, host_feats, device=cuda)  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        got_h = full_graph_inference_host(m, None, shg, host_feats, device=cuda)
        host_s = time.perf_counter() - t0
        host_launches = read_counts()
        err = rel_err(torch.from_numpy(got_h), want_h.cpu())
        check(got_h.shape == (shg.num_nodes, meta["num_classes"]), f"host {tag}: output shape")
        check(err <= HOST_TOL[tag], f"host {tag}: vs on-card full_graph_inference: {err} > {HOST_TOL[tag]}")
        check(sum(host_launches.values()) == 0, f"host {tag}: launched a kernel: {host_launches}")
        host_rows[tag] = {"seconds": host_s, "edges_per_s": len(FAN_OUT) * shg.num_edges / host_s,
                          "rel_err_vs_device_path": err}
    emit({"phase": "full_graph_inference_host", "num_nodes": shg.num_nodes, "num_edges": shg.num_edges,
          "node_chunk": 4096, "edge_chunk": 1 << 14, "models": host_rows,
          "note": "the 500k-node graph would move ~70 GB through host gathers; its timing waits "
                  "for the port's benchmark", **card})

    # ---- 13. convergence: 2 epochs, then full-graph validation accuracy ---
    conv_model = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(6), device=cuda)
    conv_tr = Trainer(model=conv_model, fan_out=FAN_OUT, dedup_last=False, device=cuda)
    conv_gen = torch.Generator(device=cuda).manual_seed(11)
    conv_seeds = SeedGenerator(arrays["train_idx"], BATCH, shuffle=True, drop_last=True, device=cuda)
    t0 = time.perf_counter()
    n_conv = 0
    last = None
    for ep in range(CONV_EPOCHS):
        for s, mk in conv_seeds.epoch(torch.Generator(device=cuda).manual_seed(200 + ep)):
            last = conv_tr.train_step(graph, features, labels, s, mk, conv_gen)
            n_conv += 1
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv_logits = full_graph_inference(conv_model, None, hg, features, device=cuda)
    vid = torch.from_numpy(arrays["valid_idx"]).to(cuda).long()
    val_acc = float((torch.argmax(conv_logits, dim=-1)[vid] == labels[vid]).float().mean())
    infer_s = time.perf_counter() - t0
    check(val_acc >= VAL_ACC_MIN, f"val_acc {val_acc} below {VAL_ACC_MIN}")
    total_s = time.perf_counter() - t_script
    emit({"phase": "convergence", "epochs": CONV_EPOCHS, "steps": n_conv, "train_s": conv_s,
          "ms_per_step": conv_s / n_conv * 1e3, "final_loss": float(last["loss"]),
          "full_graph_inference_s": infer_s, "val_acc": val_acc, "val_acc_min": VAL_ACC_MIN,
          "script_s_so_far": total_s, "share_of_script": (conv_s + infer_s) / total_s, **card})

    # ---- 14. kernels, card, result ----------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern[k] for k in keys} for kern in (k1, k2, k3, k3b, k4, k5)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
