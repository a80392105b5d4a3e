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
   injected row keys gives bit-identical blocks; K6 (``sample_uniform``,
   one kernel per hop) held bit for bit against ``sample_uniform_plain``
   on the card at the three hops of the main path, without and with
   replacement, and on a graph whose rows have degree 0, 1, k, k + 1, 2^b,
   2^b + 1 and a hub, with padded seeds, under int32 and int64 ``indptr``,
   and on seeds that are all the graph's longest row (the Feistel walk on
   its largest domain), in both modes, each case once below and once above
   the 131,072 slots from which a hop without replacement takes the packed
   kernel, the profiler checked to name the kernel that ran; an edgeless
   graph answered
   without a launch; one ``torch.cuda.graph`` capture of a hop, replayed
   on new seeds and keys copied into its buffers, equal to the plain
   version; K6's times (also queued behind a device sleep, which times
   the stream and not the host) beside the plain version's and its bound,
   and one ``sample_blocks`` call's kernels, device ms and wall ms;
4. kernels: K1 (``gather_rows``) and K3 (``gather_mean``) held against
   their plain versions on the card at the main path's shapes, plus f32,
   an odd width, all-masked rows and an empty input; times of the kernel
   (CUDA events, the device time of every op a call launches, host µs per
   call), the plain version and the PyTorch library call, and the least
   time the card could take (bytes over 3.35 TB/s); K1 also with a table
   off 16-byte alignment, one-byte rows and a short last run;
   K2 (``gather_rows_dma``) held equal to its plain version at the
   main-path shape and the gather bench's, each in bf16 and f32, an odd
   width, an L that is not a multiple of its rows per step and an empty
   input, plus the raise for a rows per step whose two stages exceed
   shared memory; its times beside K1's and ``index_select``'s;
   bench_gather: the gather bench entry point
   (``dist_gnn_tpu_torch.scripts.bench_gather2``), K2's path, one line
   per variant;
5. serving: ``Trainer.eval_step`` answers 8 batches of 512 validation
   seeds; one batch's logits are held against the plain path on the same
   blocks, and the launch counters show K6 three times, K1 once and K3
   three times per request;
6. K3-csr (``gather_mean_csr``, the full-graph walk) held against its
   plain version and run twice on the same inputs (the same bits) on the
   500k-node graph (F 100 and 256, bf16 and f32, mean and sum) and on the
   benchmark's ogbn-products-sized graph (``gnnbench/graphgen``: 2.45M
   nodes, 123.7M edges; F 100 and 256, bf16), its heavy-row plan against
   the degrees; ms, device ms, bound, plain and ``library_ms`` (the walk it
   replaced: K1 over edge chunks, the f32 cast and ``index_add_``) summed
   over a SAGE pass's three layers at the benchmark's shapes;
   full-graph inference: ``full_graph_inference`` over all 500k nodes,
   timed, its launches counted (SAGE and GCN: the plan once and K3-csr once
   a layer, nothing else; GAT: K1), and held against the same function on
   the CPU on a 20k-node graph;
7. kernels: the slot transpose and the K3 backward at SAGE layers 1 and
   2 and at a power-law slot table of 70,000 x 16 slots, above the 2^20
   keys of one bitmap window, with hub rows (f32 bitwise equal over two
   calls); the transpose also built twice on one input (equal offsets and
   lists), on a 2^21-slot table one of whose rows more than 10,000 valid
   slots name, as four kernels and no memset a build, and captured once
   in a ``torch.cuda.graph`` whose replay on a new slot table equals the
   plain version; and K4 and K5 at the three GAT layers, held against their
   plain versions on the card in bf16, plus f32, an odd width and
   all-masked rows; times as in 4.
   Before K4/K5: each GAT layer's launch plan (rows, head split, shared
   memory, blocks per SM, waves) and the HMMA (tensor-core) instructions
   of every ``gat`` kernel in ``cuobjdump -sass`` of the built library
   (bf16 kernels must have some, the exact-f32 ones none); after them,
   both kernels in bf16 and f32 at edge shapes (S not a multiple of the
   row tile, E 37 and 1024, D 7 and 47, H 1 and 8, K 1 and 32, all-masked
   rows); then K9 and K9-bwd (``ops/attention.py``, the transformer's
   scores) at the transformer cell's three layer shapes (batch 4096,
   fanout (15, 10, 5), 95% of slots valid, three rows with none) against
   their plain versions in bf16, with times, bounds and device ms, and one
   ``GraphTransformer`` step on the main path's blocks against the same
   step on the plain versions (launches: K9, K9-bwd, K4 and K5 three
   times each, K10 four); then K10 (``ops/dropout.py``, dropout) against the
   parent's ``where(keep, h / (1 - rate), 0)`` form bit for bit, output
   and gradient, at the training cells' two dropout layers ([216,576,
   256] and [24,576, 256] bf16, [216,576, 512] and [24,576, 512] f32) at
   rates 0.5 and 0.3, at odd widths, 0 and 1 rows and an input off
   16-byte alignment (the profiler naming the vector and the scalar
   kernel), timed beside its bound and its plain version;
8. training_sage / training_gat: the loss and every parameter's gradient
   on one step's blocks against the same step with every kernel swapped
   for its plain version, in f32 and in bf16, then 8 ``Trainer.train_step`` calls timed, with
   the launch counters per step (SAGE: K6 3, K1 1, K3 3, the slot
   transpose 2, K3-bwd 2; GAT: K6 3, K1 1, K4 3, K5 3; both K10 4, on
   each hidden layer's output and its gradient), a stage breakdown
   and the device's busy share; k1_or_k2_in_step: the feature gather of a
   SAGE step through K1 and through K2, in turns, in bf16 and f32;
9. serving_gat: ``Trainer.eval_step`` with the GAT model, K4 three times
   per request, logits against the plain path;
10. training_gcn / serving_gcn: one GCN step's f32 loss and gradients
    against the same step on the CPU (same blocks and keys), then 8
    ``train_step`` calls and 8 ``eval_step`` requests, K6 three times and
    K1 once per step or request, K10 four times per step and no other
    kernel;
11. full_graph_inference_gat / full_graph_inference_gcn: as 6, for the
    trained GAT and GCN;
12. full_graph_inference_host: ``full_graph_inference_host`` (features
    and activations in host memory) for SAGE, GCN and GAT on the 20k-node
    graph, against the on-card ``full_graph_inference``, timed;
13. convergence: a fresh SAGE trained for 2 epochs over the training seeds
    (bench.py:399-441), then ``full_graph_inference`` and the validation
    accuracy, which must reach 0.99 (the pinned 1.0 less the margin);
14. the host-resident tiers (features f32 in host memory): cost_model
    (``calibrate``'s K1 gather bandwidth, ``calibrate_host_staging``'s host
    gather and host → device bandwidths); cache_plan (``build_cache_plan``
    at 20% of the structure plus feature bytes, policy auto: mode, hot
    counts, the heat pass's ms, hit rates over one epoch's frontiers);
    host_tier_features (bench.py:443-497: the half of the nodes with the
    highest degree hot, miss budget 2^17, structure on the card; 2 warm-up
    and 12 timed ``HostTierTrainer.train_batches`` batches: ms, trained
    edges/s, miss rows, stage ms (host gather, copy), staged MB/s, launches;
    ``Trainer.train_step`` on the same batches beside it); host_tier_full
    (structure host-resident too, the plan's hot sets, miss budget the
    layer-0 frontier capacity, deg_cap 128; the same measures plus the
    structure misses and K6 launches, then 2 epochs and val_acc >= 0.99).
    Held: (a) ``assemble_features`` equals a plain gather of the host
    matrix exactly; (b) ``sample_staged_hop`` on the card equals the CPU's
    bit for bit at the three hops (injected keys, the same hub-row seed),
    K6 once for the hot rows and once for the staged ones; (c) the
    pipelined ``train_batches`` equals a sequential sample → stage →
    ``compute_step`` loop within 1e-5 after 6 batches; (d) every stage
    gathered through the native library built from the port's source; the
    device memory's peak over the 390 epoch batches stays within 1.25x
    (+256 MiB) of its peak over the 12 timed ones;
15. weighted sampling, on the bench graph with |N(0, 1)| weights
    (``make_synthetic_dataset(seed=0, with_probs=True)``'s): alias_tables
    (the native ``build_alias`` timed, and equal bit for bit to the numpy
    plain version on 2,001 rows; the native ``build_csc`` of
    ``HostGraph.from_coo`` timed beside its numpy version on the graph's
    edges in a random order, equal arrays); kernels_biased (K7, ``sample_biased``,
    and K8, ``sample_biased_alias``, both modes each, held against their
    plain versions on injected keys at edge shapes — degrees 0, 1, k, 2k,
    2k + 1, 31–33, a hub of 100,000, an all-zero-weight row, zero weights,
    padded seeds, int32 and int64 ``indptr``, k 5/10/15/40, and for K7's
    cut 1023/1024/1025, a 40,000-edge row with two slices of zero weights
    and the hub as 20 seeds, a 400,000-edge row past the long-row
    kernel's shared-memory table, also with ``max_degree`` understated at
    1,024 and 2,048 — at the three hops of a weighted request and
    at a hop of 64 seeds that are all the 226,746-edge row (K8 too, with
    ``scripts/bench_k8.py``'s ``shortfall``, hop 2's long rows with 9/10
    of each row's weight on one edge so that every row falls short, and
    ``k40``, the shared-memory set): ids and mask
    equal except rows whose k-th and (k+1)-th plain Gumbel keys lie within
    2 ulp, counted and printed, and K8's overflow equal; no zero-weight
    edge drawn; event, device and plain ms and the byte bound, K7's and
    K8's in both modes and per hop (K8's bound from ``bench_k8.k8_bytes``:
    a long row's draws up to its k-th first occurrence, with
    ``bytes_all_draws``, every draw charged, beside it); one K7 and one K8
    call of each mode under ``torch.cuda.set_sync_debug_mode("error")``);
    training_sage_biased (the SAGE bench config on the
    weighted graph with alias tables under the port's ``tune_sampler_for``
    caps: 8 timed steps, K8 three times a step, the overflow counters,
    busy share and top kernels (an empty profile fails), the weighted and
    the uniform step each under the padded and the tuned caps in turns,
    8 requests, then 2 epochs and val_acc >= 0.99); host_tier_biased (the
    host structure and features cell on the weighted graph: K8 on the hot
    rows and K7 on the staged rows, card == CPU per hop under the same ulp
    rule, K7 alone on each hop's staged rows timed, 12 timed batches after 2 warm-up with the hub presampling's host
    ms).

16. the distributed package (``dist_gnn_tpu_torch/parallel``) at a world
    of one on NCCL, a gloo group of the same world carrying each check's
    CPU reference: dist_exchange (``exchange_gather`` equals a K1 gather
    and runs no collective; ``sample_neighbors_sharded`` rides NCCL's
    all_to_all to itself and equals ``sample_neighbors`` on its request
    table at the three hops of a request, bit for bit; the int8 store with
    the plan's hot and peer-hot tiers and ``sample_neighbors_cached`` with
    the plan's hot structure equal the CPU's; event ms of each);
    dist_training_sage (one f32 dropout-0 ``DistTrainer.train_step``
    against ``Trainer.train_step``: loss 1e-5, gradients 1e-3; then 8
    steps at the SAGE bench config under the tuned caps, in turns with 8
    ``Trainer`` steps, with launches, collectives and host syncs per step,
    busy share and top kernels; 2 epochs and the sampled validation
    accuracy through ``DistTrainer.eval_step``, >= 0.99);
    dist_training_sage_sharded (owner-side sampling on the
    ``ShardedGraph`` with the plan's hot structure, the plan's hot features
    and the peer-hot table, bf16 and int8 stores: ms per step, exchange
    rounds, every overflow 0); dist_launches (a GAT step, K4/K5, and a
    weighted sharded SAGE step, K8; K10 four times in each); dist_inference
    (``dist_full_graph_inference`` of SAGE, GCN and GAT against
    ``full_graph_inference`` within 5e-2, edges/s); dist_world2_gloo (two
    spawned ranks on the one card over gloo, which carries their CUDA
    tensors for all_to_all, all_reduce and all_gather but not send/recv
    (``scripts/probe_gloo_cuda.py``): ``world2_gloo``'s skewed lossless
    exchange, peer-hot rows from the other rank, the gradient protocol
    and 4 ``DistTrainer`` steps on the ``ShardedGraph``).

17. the distributed host-resident tiers (``parallel/host_dist.py``,
    ``parallel/host_struct.py``), world 1 on NCCL again (a new group after
    the world-2 phase): dist_host_features (the 20% plan's feature hot set,
    structure on the card, the feature budget from ``tune_dist_tier``:
    (b) ``assemble_local`` equals a plain gather of the host matrix exactly
    through one K1 launch and no collective; (a) one f32 dropout-0
    ``DistHostTrainer.compute_step`` against ``HostTierTrainer.compute_step``
    on the same blocks and keys, loss 1e-5, gradients 1e-3; 2 warm-up and
    12 timed ``train_batches`` batches in turns with ``HostTierTrainer`` on
    the same batches and hot set: ms, stage ms, staged rows, launches,
    collectives and host syncs per batch; 2 epochs and the sampled val_acc
    through ``eval_batches``, >= 0.99); dist_host_full (the structure
    host-resident too, ``DistHostCSCStore`` with the plan's structure hot set
    and ``tune_dist_tier``'s budget and deg_cap: each hop of a request on
    the card equals the CPU bit for bit on injected keys, with the struct
    stats and hub-presampling ms; 12 timed batches in turns with
    ``HostTierTrainer``; then the weighted graph, the 5% of nodes of highest
    degree hot, card == CPU per hop under the 2-ulp near-tie rule, K8 and K7
    launched, 4 timed batches); dist_host_world2_gloo (two spawned ranks on
    the card over gloo, ``dist_host_world2``: selfless stages fewer host rows
    than selfish at equal capacity, peer-hot rows served by the other rank
    with ``peer_dropped`` 0, equal params after 3 batches,
    ``calibrate_ici`` over gloo, through the host).

18. the two-tier ``('host', 'data')`` mesh (``parallel/mesh.make_mesh(
    hosts=H)``, ``feature_store.exchange_gather_hier``): two_tier_world1
    (the mesh (1, 1) on NCCL, its sub-meshes on the world's group: the
    hierarchical exchange equals a K1 gather lossless, in one lossy round
    and with a third of the budget (the rest dropped and counted); the
    hierarchical store with the plan's hot and peer-hot tiers equals the
    flat store; K1 at the response's flag-column widths, 101 bf16 and 105
    packed bytes, beside 100 and 104; 3 f32 ``DistTrainer`` steps on the
    tuple axis against the flat axis, same params and keys: loss 1e-5,
    params 1e-3; the collectives per axis); two_tier_world4_gloo (four
    spawned ranks on the card over gloo as (2, 2), ``two_tier_world4``
    (a)-(g): the skewed exchange in 16 rounds, hierarchical == flat,
    peer-hot inside a host, the gradient protocol, 4 ``DistTrainer`` steps
    at the SAGE bench config with the selfless 20% plan over four ranks,
    one ``DistHostTrainer`` batch with host features and structure,
    ``calibrate_ici`` per axis); dryrun_multichip (``entry.dryrun_multichip(4,
    backend="gloo")``: the flagship composition on (2, 2), every loss
    finite).

19. the apps and the dataset I/O (``examples/graphsage``,
    ``dataloading/preprocess.py``, ``scripts/bench_scale.py``), each phase
    one line with the card's name and power limit: dataset_io (the bench
    arrays with their weights written by ``save_dataset`` into a temporary
    directory, read back by ``load_dataset(mmap=True)`` as read-only
    memmaps equal to them, the graph uploaded from the memmaps equal to
    the in-memory one with no warning, and ``make_ogb_raw_fixture`` +
    ``process_ogb_raw`` for ogbn-products and ogbn-papers100M at 2,000
    nodes: shapes, dtypes, degrees and values, parsed without pandas);
    app_sage (``node_classification.main`` on the saved dataset at the
    bench config, bf16, 2 epochs, ``--autotune --full-eval --checkpoint
    --metrics-log``: val_acc >= 0.99 after epoch 2, the full-graph test
    accuracy >= 0.99, the log's events and fields, every parameter on
    ``cuda:0``, K6/K1/K3/the slot transpose/K3-bwd/K10 launched, ms per step
    beside training_sage's ``Trainer`` ms; then ``--resume`` for one epoch,
    the step carried on); app_variants (one epoch each of ``--model gat``
    (hidden 128), ``--model gcn``, ``--bias`` (K8), ``--unroll 4``,
    ``--profile``, ``--tier host``, ``--tier host --host-struct``,
    ``--tier dist-host`` and ``--dist``, the last two as a spawned world of
    one on NCCL: epoch time, loss, val_acc, launches); app_dist
    (``node_classification_dist.main`` with ``--procs 2
    --devices-per-process 2``, four ranks on the card over gloo at the
    app's defaults, both tiers; the world of one at the bench width runs
    the same trainers as app_variants' ``--dist`` and ``--tier
    dist-host``); scale (``bench_scale.run`` at 500k and at 2M nodes,
    average degree 15, in this process: the bench config's step against
    the graph's size).  Every spawned world waits at most 600 s.

Then the profiler's count of sessions that lost kernel records
(``utils/timing.profile_device``), the ``{"kernels": [...]}`` line (K6,
K1, K2, K3, K3-bwd, K4, K5, K9, K9-bwd, K10, the slot transpose, K7, K8, each with its
device ms, its launches per distributed step and per ``DistHostTrainer``
batch at world 1: K7 and K8 from the weighted host-structure run, the
others from dist_host_features; and per two-tier ``DistTrainer`` step,
from rank 0 of two_tier_world4_gloo (e)), the card's name and
power limit as nvidia-smi gives them, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises, and
the script exits non-zero without the last line.  It needs no network
and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
FAN_OUT = (15, 10, 5)
K6_PACKED_SLOTS = 131_072  # csrc/sampling.cu kQueueSlots: K6's packed kernel from here up
BATCH = 512
N_REQUESTS = 8
N_STEPS = 8
DROPOUT_PER_STEP = 2 * (len(FAN_OUT) - 1)  # K10 on each hidden layer's output, then on its gradient
CONV_EPOCHS = 2  # bench.py:54
VAL_ACC_MIN = 1.0 - 0.01  # the pinned target less its margin (bench.py:52-53)
# bf16 tolerances, as a share of the reference's largest magnitude: K3
# sums in f32 and rounds once where the plain version rounds the sum and
# the quotient in bf16, so single elements differ by a bf16 ulp (2**-8
# relative) and the difference compounds through three layers.
K3_BF16_TOL = 1e-2
K3_F32_TOL = 1e-5
# K3-csr in f32 against its plain version: the same sums in another order
# (the plain version's index_add_ adds atomically on the card) over rows of
# thousands of in-edges, so the sum epilogue's largest rows part by tens of
# f32 ulps of the largest output (2.95e-5 at 500k nodes, F 100); a lost or
# doubled edge moves its row by a whole term, far above this.
K3CSR_F32_TOL = 1e-4
LOGITS_BF16_TOL = 5e-2
# K4 in bf16, as a share of the plain version's largest magnitude: both
# round alpha and agg to bf16, but from f32 sums taken in another order, so
# an element may land one bf16 ulp (2**-8) apart before the projection.
K4_BF16_TOL = 1e-2
# f32: the same arithmetic summed in another order.
K4_F32_TOL = 1e-5
# K9's scores against its plain version: f32 sums of the same bf16 products
# in another order, as a share of the largest score; its backward writes
# the folded queries' gradient and adds into d_x in bf16, each from f32
# sums taken in another order, so an element may land a bf16 ulp (2**-8)
# apart, as K4's output may.
K9_SCORE_TOL = 1e-4
K9_BWD_BF16_TOL = 1e-2
# The K3 backward and K5 in f32: sums in another order than the plain
# version's (whose index_add_ on the card adds atomically), and K5's dW
# atomics across blocks in an order that changes per run.
BWD_F32_TOL = 1e-4
# ... and on bf16 inputs: K5 rounds agg to bf16 before dW and writes dxn in
# bf16, the K3 backward rounds its f32 sum to bf16, each from sums in
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


ATTN_CELL_LAYERS = ((5, 216_576, 100), (10, 24_576, 512), (15, 4_096, 512))  # (K, S, E), input-first


def attention_phase(cuda, gen, blocks, call_device_ms, cuda_time_ms, card) -> tuple:
    """K9 and K9-bwd (``ops/attention.py``) against their plain versions at
    the transformer cell's three layer shapes (95% of slots valid, three
    rows with none), bf16, with times, bounds, device ms and the library
    form's time (``torch.einsum``, no mask and no shift); then one
    forward and backward of ``GraphTransformer`` on the main path's
    ``blocks`` with every kernel against the same step on the plain
    versions, and its launches.  Returns the kernels line's K9 and K9-bwd
    entries."""
    import torch

    from dist_gnn_tpu_torch.models.transformer import GraphTransformer
    from dist_gnn_tpu_torch.ops import attention as attn_ops
    from dist_gnn_tpu_torch.ops import dropout as drop_ops
    from dist_gnn_tpu_torch.ops import gat as gat_ops

    H = 4
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0}
    bwd = dict(fwd)
    layers, err_f, err_b = [], 0.0, 0.0
    for l, (K, S, E) in enumerate(ATTN_CELL_LAYERS):
        x_n = torch.randn(K, S, E, device=cuda, generator=gen).to(torch.bfloat16)
        qt = (torch.randn(H, S, E, device=cuda, generator=gen) * 0.1).to(torch.bfloat16)
        mask_f = (torch.rand(S, K, device=cuda, generator=gen) < 0.95).float()
        mask_f[:3] = 0
        ds = torch.randn(K, S, H, device=cuda, generator=gen)
        dxn = torch.randn(K, S, E, device=cuda, generator=gen).to(torch.bfloat16)
        scale = 128 ** -0.5
        need_dx = l > 0  # as in a training step
        s = attn_ops.score_fwd(x_n, qt, mask_f, scale)
        e_s = share_err(s, attn_ops.score_fwd_plain(x_n, qt, mask_f, scale))
        check(e_s <= K9_SCORE_TOL, f"K9 layer {l}: error {e_s} > {K9_SCORE_TOL}")
        check(bool((s[:, :3] == 0).all()), "K9: rows with no valid slot must score 0")
        got = attn_ops.score_bwd(x_n, qt, mask_f, ds, dxn.clone() if need_dx else None, scale)
        want = attn_ops.score_bwd_plain(x_n, qt, mask_f, ds, dxn.clone() if need_dx else None, scale)
        e_b = {}
        for name, a, b in zip(("dqt", "dxn"), got, want):
            check((a is None) == (b is None) == (name == "dxn" and not need_dx), f"K9-bwd {name} presence")
            if a is not None:
                e_b[name] = share_err(a, b)
                check(e_b[name] <= K9_BWD_BF16_TOL, f"K9-bwd layer {l} {name}: error {e_b[name]}")
        check(bool((got[0][:, :3] == 0).all()), "K9-bwd: rows with no valid slot must have 0 gradients")
        V = int(mask_f.sum())
        bf = V * E * 2 + H * S * E * 2 + S * K * 4 + K * S * H * 4
        bb = V * E * 2 + 2 * H * S * E * 2 + V * H * 4 + S * K * 4 + (2 * V * E * 2 if need_dx else 0)
        ff, fb = 2 * V * E * H, 2 * V * E * H * (2 if need_dx else 1)
        args_b = (x_n, qt, mask_f, ds, dxn if need_dx else None, scale)
        ds_lo = ds.to(torch.bfloat16)

        def library_bwd():  # the two products in x's dtype, without the mask
            dqt = torch.einsum("ksh,kse->hse", ds_lo, x_n)
            return dqt, dxn.add_(torch.einsum("ksh,hse->kse", ds_lo, qt)) if need_dx else None

        lay_f = {"layer": l, "K": K, "S": S, "E": E, "H": H, "valid_slots": V, "bytes": bf, "flops": ff,
                 "err": e_s, "ms": cuda_time_ms(lambda: attn_ops.score_fwd(x_n, qt, mask_f, scale)),
                 "plain_ms": cuda_time_ms(lambda: attn_ops.score_fwd_plain(x_n, qt, mask_f, scale), iters=5),
                 "library_ms": cuda_time_ms(lambda: torch.einsum("kse,hse->ksh", x_n, qt)),
                 "bound_ms": max(bf / HBM_BYTES_PER_S, ff / BF16_FLOPS) * 1e3,
                 "device_ms": call_device_ms(lambda: attn_ops.score_fwd(x_n, qt, mask_f, scale),
                                             ["attn_score_fwd"])}
        lay_b = {"layer": l, "K": K, "S": S, "E": E, "H": H, "need_dx": need_dx, "bytes": bb, "flops": fb,
                 "err": e_b, "ms": cuda_time_ms(lambda: attn_ops.score_bwd(*args_b)),
                 "plain_ms": cuda_time_ms(lambda: attn_ops.score_bwd_plain(*args_b), iters=5),
                 "library_ms": cuda_time_ms(library_bwd),
                 "bound_ms": max(bb / HBM_BYTES_PER_S, fb / BF16_FLOPS) * 1e3,
                 "device_ms": call_device_ms(lambda: attn_ops.score_bwd(*args_b), ["attn_score_bwd"])}
        for acc, lay in ((fwd, lay_f), (bwd, lay_b)):
            for key in acc:
                acc[key] += lay[key]
        err_f = max(err_f, max_abs(s, attn_ops.score_fwd_plain(x_n, qt, mask_f, scale)))
        err_b = max(err_b, max(max_abs(a, b) for a, b in zip(got, want) if a is not None))
        layers.append({"fwd": lay_f, "bwd": lay_b})
        del x_n, qt, mask_f, ds, ds_lo, dxn, s, got, want

    # one training step's forward and backward of the model, kernels against plain versions
    model = GraphTransformer(100, 128, 47, len(blocks), num_heads=H, compute_dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(21), device=cuda)
    for p in model.parameters():  # no zero start, so every path carries a gradient
        with torch.no_grad():
            p.add_(0.05 * torch.randn(p.shape, device=cuda, generator=gen))
    x = torch.randn(blocks[0].num_src, 100, device=cuda, generator=gen).to(torch.bfloat16)
    drop = [torch.randint(0, 2**32, (b.num_dst,), device=cuda, generator=gen, dtype=torch.int64)
            for b in blocks[:-1]]

    def step():
        model.zero_grad(set_to_none=True)
        out = model(blocks, x, train=True, rng=list(drop), contiguous_first=True)
        out.float().square().mean().backward()
        return out.detach().float(), {n: p.grad.float().clone() for n, p in model.named_parameters()}

    counters = (attn_ops.score_fwd, attn_ops.score_bwd, gat_ops.gat_fwd, gat_ops.gat_bwd, drop_ops.dropout)
    before = [c.launches for c in counters]
    out_k, grads_k = step()
    torch.cuda.synchronize()
    launches = dict(zip(("attn_score_fwd", "attn_score_bwd", "gat_fwd", "gat_bwd", "dropout"),
                        (c.launches - b for c, b in zip(counters, before))))
    check(all(n == len(blocks) for k, n in launches.items() if k != "dropout")
          and launches["dropout"] == 2 * (len(blocks) - 1), f"transformer step launches {launches}")
    swaps = [(attn_ops, "score_fwd", attn_ops.score_fwd_plain), (attn_ops, "score_bwd", attn_ops.score_bwd_plain),
             (gat_ops, "gat_fwd", gat_ops.gat_fwd_plain), (gat_ops, "gat_bwd", gat_ops.gat_bwd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        out_p, grads_p = step()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    step_logit = share_err(out_k, out_p)
    step_grad = max(float((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm()) for n in grads_p)
    check(step_logit <= LOGITS_BF16_TOL, f"transformer step logits: {step_logit} > {LOGITS_BF16_TOL}")
    check(step_grad <= GRAD_BF16_TOL, f"transformer step gradients: {step_grad} > {GRAD_BF16_TOL}")
    library = ("torch.einsum in bf16: the scores kse,hse->ksh; the backward's ksh,kse->hse and, where d_x is "
               "asked for, ksh,hse->kse added into d_x; no mask and no shift")
    k9 = {"name": "attn_score_fwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/attention.cu",
          "replaces": None, "launches": launches["attn_score_fwd"], "max_abs_err": err_f, **fwd,
          "bound_by": "bytes"}
    k9b = {"name": "attn_score_bwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/attention.cu",
           "replaces": None, "launches": launches["attn_score_bwd"], "max_abs_err": err_b, **bwd,
           "bound_by": "bytes"}
    for kern in (k9, k9b):  # no distributed or host-tier phase runs the transformer
        kern.update(dist_launches_per_step=None, dist_host_launches_per_batch=None, two_tier_launches_per_step=None)
    emit({"phase": "kernel", "kernel": "K9 attn_score_fwd and K9-bwd attn_score_bwd", "dtype": "bfloat16",
          "library": library, "shapes_are": "the transformer cell's three layers (batch 4096, fanout 15/10/5)",
          "times_are": "sums over the three layers", "layers": layers, "k9": k9, "k9_bwd": k9b,
          "transformer_step": {"batch": blocks[-1].num_dst, "launches": launches, "logit_err": step_logit,
                               "worst_grad_norm_err": step_grad}, **card})
    return k9, k9b


# The training cells' two dropout layers a step (rows, width, dtype): SAGE's
# in bf16, GAT's and the transformer's 512-wide f32 outputs.
DROPOUT_CELL_SHAPES = ((216_576, 256, "bfloat16"), (24_576, 256, "bfloat16"),
                       (216_576, 512, "float32"), (24_576, 512, "float32"))


def dropout_phase(cuda, gen, blocks, call_device_ms, cuda_time_ms, card) -> dict:
    """K10 (``ops/dropout.py``) against its plain version, the parent's
    ``where(keep, h / (1 - rate), 0)`` form, bit for bit, forward and
    gradient, at the training cells' shapes (rates 0.5 and 0.3), at odd
    widths, 0 and 1 rows and an input off 16-byte alignment; the profiler
    names the vector kernel at the cells' shapes and the scalar one at an
    odd width.  Then inside one train-mode step of SAGE, GAT and the
    transformer on the main path's ``blocks``: each dropout call against
    the plain version on the same input, output and the gradient it
    passes back, bitwise; and the whole step twice with K10 and twice
    with the plain version, reporting which logits and gradients differ
    (GAT's and the transformer's backward add floats in no fixed order,
    so two K10 steps differ there too).  Times at rate 0.5: the kernel,
    its device ms, the plain version and the bound (each element read and
    written once, and the keys).  No one library call computes this
    mask.  Returns the kernels line's K10 entry without its launches,
    which the training phases count."""
    import torch

    from dist_gnn_tpu_torch.models import sage as sage_mod
    from dist_gnn_tpu_torch.models.gat import GAT
    from dist_gnn_tpu_torch.models.transformer import GraphTransformer
    from dist_gnn_tpu_torch.ops import dropout as drop_ops
    from dist_gnn_tpu_torch.utils.timing import profile_device

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def same(h, keys, rate):
        """K10's output on h as it lies (its alignment too) and its gradient
        against the plain version's, bitwise; the share of h kept."""
        g = torch.randn(h.shape, device=cuda, generator=gen).to(h.dtype)
        before = drop_ops.dropout.launches
        out = drop_ops.dropout(h, keys, rate)
        hk = h.clone().requires_grad_()
        drop_ops.dropout(hk, keys, rate).backward(g)
        hp = h.clone().requires_grad_()
        drop_ops.dropout_plain(hp, keys, rate).backward(g)
        ref = drop_ops.dropout_plain(h, keys, rate)
        torch.cuda.synchronize()
        tag = f"K10 {tuple(h.shape)} {h.dtype} rate {rate}"
        check(drop_ops.dropout.launches - before == (3 if h.numel() else 0), f"{tag}: launches")
        check(torch.equal(bits(out), bits(ref)), f"{tag}: output differs from the where form")
        check(torch.equal(bits(hk.grad), bits(hp.grad)), f"{tag}: gradient differs from the where form")
        return float((out != 0).float().mean()) if h.numel() else None

    def ran(fn, which):
        kernels, _ = profile_device(fn, iters=10)  # as call_device_ms: one launch's record can be lost
        names = sorted({k for k in kernels if "dropout_" in k})
        check(len(names) == 1 and which in names[0], f"K10 ran {names}, not {which}")

    shapes, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0}
    for S, H, dt in DROPOUT_CELL_SHAPES:
        dtype = getattr(torch, dt)
        h = torch.randn(S, H, device=cuda, generator=gen).to(dtype)
        keys = torch.randint(0, 2**32, (S,), device=cuda, generator=gen, dtype=torch.int64)
        kept = {rate: same(h, keys, rate) for rate in (0.5, 0.3)}
        nbytes = 2 * S * H * h.element_size() + S * 8
        row = {"S": S, "H": H, "dtype": dt, "kept_share": kept, "bytes": nbytes,
               "ms": cuda_time_ms(lambda: drop_ops.dropout(h, keys, 0.5)),
               "device_ms": call_device_ms(lambda: drop_ops.dropout(h, keys, 0.5), ["dropout_"]),
               "plain_ms": cuda_time_ms(lambda: drop_ops.dropout_plain(h, keys, 0.5), iters=5, warmup=1),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        for key in tot:
            tot[key] += row[key]
        shapes.append(row)
        if S == DROPOUT_CELL_SHAPES[0][0]:
            ran(lambda: drop_ops.dropout(h, keys, 0.5), "dropout_vec_kernel")
        del h, keys
    # the scalar kernel: odd widths, rows off 16 bytes, an input off alignment
    edge = []
    for S, H, dt in ((1000, 17, "bfloat16"), (999, 47, "float32"), (513, 100, "bfloat16"), (1, 512, "float32"),
                     (0, 256, "bfloat16")):
        dtype = getattr(torch, dt)
        h = torch.randn(S, H, device=cuda, generator=gen).to(dtype)
        keys = torch.randint(0, 2**32, (S,), device=cuda, generator=gen, dtype=torch.int64)
        edge.append({"S": S, "H": H, "dtype": dt, "kept_share": [same(h, keys, r) for r in (0.5, 0.3, 0.1)]})
    h = torch.randn(3000, 47, device=cuda, generator=gen)
    keys = torch.randint(0, 2**32, (3000,), device=cuda, generator=gen, dtype=torch.int64)
    ran(lambda: drop_ops.dropout(h, keys, 0.5), "dropout_scalar_kernel")
    flat = torch.randn(4000 * 64 + 1, device=cuda, generator=gen)[1:].view(4000, 64)  # 4 bytes off 16
    keys = torch.randint(0, 2**32, (4000,), device=cuda, generator=gen, dtype=torch.int64)
    check(drop_ops.vector_width(64, flat.dtype, flat.data_ptr()) == 1, "an unaligned input takes the scalar kernel")
    edge.append({"S": 4000, "H": 64, "dtype": "float32", "offset_bytes": 4, "kept_share": same(flat, keys, 0.3)})

    def in_model(name, model):
        with torch.no_grad():
            for p in model.parameters():  # no zero start, so every path carries a gradient
                p.add_(0.05 * torch.randn(p.shape, device=cuda, generator=gen))
        x = torch.randn(blocks[0].num_src, 100, device=cuda, generator=gen).to(torch.bfloat16)
        drop = [torch.randint(0, 2**32, (b.num_dst,), device=cuda, generator=gen, dtype=torch.int64)
                for b in blocks[:-1]]
        calls = []

        def recorded(h, keys, rate):
            out = drop_ops.dropout(h, keys, rate)
            call = {"h": h.detach().clone(), "keys": keys, "rate": rate, "out": out.detach().clone()}
            h.register_hook(lambda g: call.__setitem__("dh", g.detach().clone()))
            out.register_hook(lambda g: call.__setitem__("g", g.detach().clone()))
            calls.append(call)
            return out

        def step(impl):
            saved = sage_mod.dropout
            sage_mod.dropout = impl
            try:
                model.zero_grad(set_to_none=True)
                out = model(blocks, x, train=True, rng=list(drop), contiguous_first=True)
                out.float().square().mean().backward()
            finally:
                sage_mod.dropout = saved
            torch.cuda.synchronize()
            return out.detach().clone(), {n: p.grad.clone() for n, p in model.named_parameters()}

        before = drop_ops.dropout.launches
        k_1 = step(recorded)
        check(drop_ops.dropout.launches - before == DROPOUT_PER_STEP == 2 * len(calls), f"{name} step: K10 launches")
        for i, c in enumerate(calls):
            hp = c["h"].clone().requires_grad_()
            ref = drop_ops.dropout_plain(hp, c["keys"], c["rate"])
            ref.backward(c["g"])
            check(torch.equal(bits(c["out"]), bits(ref.detach())), f"{name} step, dropout {i}: output differs")
            check(torch.equal(bits(c["dh"]), bits(hp.grad)), f"{name} step, dropout {i}: gradient differs")
        k_2, p_1, p_2 = step(drop_ops.dropout), step(drop_ops.dropout_plain), step(drop_ops.dropout_plain)

        def differ(a, b):  # the parameters whose gradients differ, with the largest difference
            return {n: float((a[1][n].float() - b[1][n].float()).abs().max())
                    for n in a[1] if not torch.equal(a[1][n], b[1][n])}

        pairs = {"k10_k10": (k_1, k_2), "plain_plain": (p_1, p_2), "k10_plain": (k_1, p_1)}
        return {"dropout_calls": [[*c["h"].shape, str(c["h"].dtype).removeprefix("torch.")] for c in calls],
                "calls_bit_equal": True, "params": len(k_1[1]),
                "logits_equal": {t: torch.equal(a[0], b[0]) for t, (a, b) in pairs.items()},
                "grads_differ": {t: differ(a, b) for t, (a, b) in pairs.items()}}

    L = len(blocks)
    models = {"sage": sage_mod.SAGE(100, 256, 47, L, compute_dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(4), device=cuda),
              "gat": GAT(100, 128, 47, L, num_heads=4, compute_dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(5), device=cuda),
              "transformer": GraphTransformer(100, 128, 47, L, num_heads=4, compute_dtype=torch.bfloat16,
                                              generator=torch.Generator().manual_seed(21), device=cuda)}
    steps = {name: in_model(name, m) for name, m in models.items()}
    k10 = {"name": "dropout", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/sampling.cu",
           "replaces": None, "max_abs_err": 0.0, **tot, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "kernel", "kernel": "K10 dropout", "bit_equal": True, "in_model_steps": steps,
          "library": "none: no one PyTorch call computes the keyed per-row mask",
          "shapes_are": "the training cells' two dropout layers (SAGE bf16, GAT and transformer f32)",
          "times_are": "forward at rate 0.5, sums over the four shapes", "shapes": shapes, "edge_shapes": edge,
          **{k: k10[k] for k in tot}, **card})
    return k10


def kernel_counters() -> dict:
    """Every kernel wrapper by name; each adds one to its ``launches`` where
    it launches its kernel, and nowhere else."""
    from dist_gnn_tpu_torch.ops import dropout as drop_ops
    from dist_gnn_tpu_torch.ops import gat as gat_ops
    from dist_gnn_tpu_torch.ops import gather, sampling

    return {"sample_uniform": sampling.sample_uniform, "sample_biased": sampling.sample_biased,
            "sample_biased_alias": sampling.sample_biased_alias,
            "gather_rows": gather.gather_rows, "gather_rows_dma": gather.gather_rows_dma,
            "gather_mean": gather.gather_mean, "slot_transpose": gather.slot_transpose,
            "gather_mean_bwd": gather.gather_mean_bwd, "gather_mean_csr": gather.gather_mean_csr,
            "csr_plan": gather.csr_plan, "gat_fwd": gat_ops.gat_fwd, "gat_bwd": gat_ops.gat_bwd,
            "dropout": drop_ops.dropout}


def world2_gloo(mesh, caps, num_nodes) -> dict:
    """One rank of the world-2 phase (``launch`` spawns two on the card, over
    gloo): each builds the bench graph (``num_nodes`` 500,000) from its
    seed and checks (a) an
    exchange whose every id lies in shard 0, over a budget of 256 for
    4,096 ids a rank: lossless, exact, in 16 rounds; (b) peer-hot rows
    served from the other rank's hot tier while the base shards lie about
    them (and the base's lie without the peer tier); (c) the gradient
    protocol of ``tests/test_parallel.py:149-256``: on fixed blocks, the
    summed gradient of the globally normalised loss (features through the
    exchange) against the single-device gradient of the concatenated
    batch, f32, dropout 0 (loss 1e-5, gradients 1e-3); (d) 4
    ``DistTrainer`` steps on the ``ShardedGraph`` at the SAGE bench config,
    512 seeds a rank, 3 timed.  Returns its measures."""
    import numpy as np
    import torch

    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models.sage import SAGE
    from dist_gnn_tpu_torch.parallel import feature_store as dfs
    from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph
    from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.training import dist_masked_nll_loss

    cuda, n, me = mesh.device, mesh.size, mesh.rank
    sync = torch.cuda.synchronize if cuda.type == "cuda" else (lambda: None)
    out = {"rank": me, "backend": mesh.backend, "device": str(cuda)}
    arrays, meta = make_synthetic_dataset(
        num_nodes=num_nodes, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=0,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    feats = arrays["features"]
    N = hg.num_nodes
    # (a) adversarial skew: every id in shard 0, a budget far below the load
    store = dfs.ShardedFeatureStore(feats, mesh)
    L, budget = 4096, 256
    ids = torch.from_numpy(np.random.default_rng(10 + me).integers(0, store.shard_size, L).astype(np.int32)).to(cuda)
    mesh.reset_counts()
    t0 = time.perf_counter()
    rows, uns = dfs.exchange_gather(store.features, ids, torch.ones(L, dtype=torch.bool, device=cuda), mesh,
                                    store.shard_size, budget=budget)
    sync()
    skew_ms = (time.perf_counter() - t0) * 1e3
    rounds = mesh.counts["host_syncs"]
    check(torch.equal(rows.cpu(), torch.from_numpy(feats[ids.cpu().long()])) and int(uns) == 0,
          f"world 2 rank {me}: the skewed exchange lost or changed rows")
    check(rounds == -(-L // budget), f"world 2 rank {me}: {rounds} rounds, expected {-(-L // budget)}")
    out["skew"] = {"ids": L, "budget": budget, "rounds": rounds, "all_to_all": mesh.counts["all_to_all"],
                   "ms": skew_ms}
    # (b) peer-hot: disjoint hot sets, the base shards lie about hot rows
    C = min(20_000, N // 4)
    hot = np.random.default_rng(20).permutation(N)[: 2 * C].reshape(2, C).astype(np.int32)
    lie = feats.copy()
    lie[hot.reshape(-1)] = -777.0
    q_np = np.concatenate([hot[1 - me][:L], np.random.default_rng(30 + me).integers(0, N, 1024)]).astype(np.int32)
    q = torch.from_numpy(q_np).to(cuda)
    peer_rows = {}
    for peer in (True, False):
        st = dfs.ShardedFeatureStore(feats, mesh, hot_ids=hot, peer_hot=peer)
        st.features = st.shard_of(lie)
        r_, u_ = st.fetch_local(q, torch.ones(len(q_np), dtype=torch.bool, device=cuda), budget=len(q_np))
        check(int(u_) == 0, f"world 2 rank {me}: peer-hot fetch unserved {int(u_)}")
        peer_rows[peer] = r_.cpu().numpy()
    other_hot = np.isin(q_np, hot[1 - me])
    mine_hot = np.isin(q_np, hot[me])
    check(np.array_equal(peer_rows[True], feats[q_np]), f"world 2 rank {me}: peer-hot rows are not the true rows")
    check(bool((peer_rows[False][other_hot & ~mine_hot] == -777.0).all()),
          f"world 2 rank {me}: without the peer tier the other rank's hot rows should come from the base")
    out["peer_hot"] = {"ids": len(q_np), "hot_on_the_other_rank": int((other_hot & ~mine_hot).sum()),
                       "true_rows_with_peer_tier": True}
    # (c) the gradient protocol on fixed blocks
    graph = hg.to_device(cuda)
    seeds = np.random.default_rng(40).choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32)
    blocks = [sample_blocks(graph, torch.from_numpy(seeds[c * BATCH:(c + 1) * BATCH]).to(cuda),
                            torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                            torch.Generator(device=cuda).manual_seed(100 + c), dedup_last=False)[0]
              for c in range(n)]
    labels = torch.from_numpy(arrays["labels"]).to(cuda)
    model = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), dropout=0.0,
                 generator=torch.Generator().manual_seed(41), device=cuda)
    ref = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), dropout=0.0,
               generator=torch.Generator().manual_seed(41), device=cuda)
    mine = blocks[me]
    fr = mine[-1].frontier
    rows, _ = store.fetch_local(fr, mine[-1].frontier_mask, budget=fr.shape[0])
    lab = labels[torch.from_numpy(seeds[me * BATCH:(me + 1) * BATCH]).to(cuda).long()]
    loss, _ = dist_masked_nll_loss(model, False, mesh, mine, rows, lab, mine[0].seed_mask, None)
    loss.backward()
    grads = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    loss_dist = float(mesh.all_reduce(loss.detach().reshape(1))[0])
    feats_dev = torch.from_numpy(feats).to(cuda)
    total = 0.0
    for c, blk in enumerate(blocks):
        safe = torch.where(blk[-1].frontier_mask, blk[-1].frontier, 0).long()
        logits = ref(tuple(reversed(blk)), feats_dev[safe], contiguous_first=True)
        lab_c = labels[torch.from_numpy(seeds[c * BATCH:(c + 1) * BATCH]).to(cuda).long()]
        total = total - torch.log_softmax(logits.float(), -1).gather(1, lab_c[:, None].long()).sum()
    total = total / (n * BATCH)
    total.backward()
    total = float(total.detach())
    ref_grads = torch.cat([p.grad.reshape(-1) for p in ref.parameters()])
    loss_err = abs(loss_dist - total) / max(1.0, abs(total))
    off, grad_err = 0, {}
    for name, p in ref.named_parameters():
        grad_err[name] = share_err(grads[off:off + p.numel()], ref_grads[off:off + p.numel()])
        off += p.numel()
    check(loss_err <= LOSS_F32_TOL, f"world 2 rank {me}: dist loss {loss_dist} vs single-device {total}")
    check(all(e <= GRAD_F32_TOL for e in grad_err.values()), f"world 2 rank {me}: gradients {grad_err}")
    out["grad"] = {"loss_dist": loss_dist, "loss_single_device": total, "loss_err": loss_err,
                   "grad_share_err": grad_err}
    del graph, feats_dev, blocks, model, ref
    # (d) DistTrainer on the ShardedGraph, 512 seeds a rank
    sg = ShardedGraph.build(hg, mesh)
    store_bf = dfs.ShardedFeatureStore(torch.from_numpy(feats).to(torch.bfloat16), mesh)
    tr = DistTrainer(model=SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(60), device=cuda),
                     fan_out=FAN_OUT, store=store_bf, sgraph=sg, dedup_last=False, frontier_caps=caps)
    labs = store_bf.shard_of(labels[:, None])
    brng = np.random.default_rng(80)
    batches = [(torch.from_numpy(brng.choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32)).to(cuda),
                torch.ones(n * BATCH, dtype=torch.bool, device=cuda)) for _ in range(4)]
    gen = torch.Generator(device=cuda).manual_seed(70 + me)
    tr.train_step(None, labs, *batches[0], gen)  # warm-up
    sync()
    mesh.reset_counts()
    t0 = time.perf_counter()
    mets = [tr.train_step(None, labs, s, mk, gen) for s, mk in batches[1:]]
    sync()
    step_ms = (time.perf_counter() - t0) / len(mets) * 1e3
    ovf = sum(int(m_["overflow"]) + int(m_["sampler_overflow"]) + int(m_["frontier_overflow"]) for m_ in mets)
    check(ovf == 0 and all(np.isfinite(float(m_["loss"])) for m_ in mets), f"world 2 rank {me}: overflow {ovf}")
    out["train"] = {"steps": len(mets), "ms_per_step": step_ms, "losses": [float(m_["loss"]) for m_ in mets],
                    "collectives_per_step": {k: v / len(mets) for k, v in mesh.counts.items()},
                    "exchange_rounds_per_step": mesh.counts["host_syncs"] / len(mets)}
    psum = torch.stack([p.detach().double().sum() for p in tr.model.parameters()]).sum().reshape(1)
    sums = [float(x) for x in mesh.all_gather(psum)]
    check(sums[0] == sums[1], f"world 2 rank {me}: the ranks' params differ after training ({sums})")
    return out


def dist_host_world2(mesh, num_nodes) -> dict:
    """One rank of the dist_host_world2_gloo phase (two ranks on the card over
    gloo): each builds the bench graph (``num_nodes`` 500,000) and its f32
    features in host memory from the seed, and trains ``DistHostTrainer``
    (structure on the card, 512 seeds a rank) under two feature plans of
    equal per-rank capacity, a tenth of the nodes: selfless (the
    highest-degree fifth split between the ranks) and selfish (the
    highest-degree tenth on both); after a warm-up batch each, 3 batches
    twice, in turns.  Checks: (a) selfless stages strictly fewer host rows
    than selfish on the same batches; (b) on one batch's frontier,
    ``assemble_local`` equals the host matrix exactly, with rows hot only
    on the other rank served from it and ``peer_dropped`` 0; (c) every
    batch's ``peer_dropped`` 0 and the ranks' params equal after training.
    Also ``calibrate_ici`` over this gloo pair (through the host, not
    NVLink).  Returns its measures."""
    import numpy as np
    import torch

    from dist_gnn_tpu_torch.cache.cost_model import calibrate_ici
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.models.sage import SAGE
    from dist_gnn_tpu_torch.parallel.feature_store import request_budget
    from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
    from dist_gnn_tpu_torch.sampler import sample_blocks

    cuda, n, me = mesh.device, mesh.size, mesh.rank
    sync = torch.cuda.synchronize if cuda.type == "cuda" else (lambda: None)
    out = {"rank": me, "backend": mesh.backend, "device": str(cuda)}
    arrays, meta = make_synthetic_dataset(
        num_nodes=num_nodes, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=0,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    feats = np.ascontiguousarray(arrays["features"], np.float32)
    labels_np = np.asarray(arrays["labels"], np.int32)
    graph = hg.to_device(cuda)
    C = hg.num_nodes // 10
    order = np.argsort(-np.diff(hg.indptr.astype(np.int64)), kind="stable").astype(np.int32)
    plans = {"selfless": order[: n * C].reshape(C, n).T.copy(), "selfish": np.tile(order[:C], (n, 1))}
    rng = np.random.default_rng(90)
    batches = [(rng.choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32), np.ones(n * BATCH, bool))
               for _ in range(4)]  # one warm-up, 3 timed
    # (b) one frontier through the three tiers
    store = DistHostFeatureStore(feats, mesh, plans["selfless"], miss_budget=1 << 15)
    mine = slice(me * BATCH, (me + 1) * BATCH)
    blk, _ = sample_blocks(graph, torch.from_numpy(batches[0][0][mine]).to(cuda),
                           torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                           torch.Generator(device=cuda).manual_seed(91 + me), dedup_last=False)
    fr, frm = blk[-1].frontier, blk[-1].frontier_mask
    fr_np, frm_np = fr.cpu().numpy(), frm.cpu().numpy()
    staged = store.stage(fr_np, frm_np)
    staged.wait()
    mesh.reset_counts()
    rows, dropped = store.assemble_local(fr, frm, staged, request_budget(fr.shape[0], n, 4.0))
    want = np.where(frm_np[:, None], feats[np.where(frm_np, fr_np, 0)], 0)
    peer = frm_np & np.isin(fr_np, plans["selfless"][1 - me]) & ~np.isin(fr_np, plans["selfless"][me])
    check(np.array_equal(rows.cpu().numpy(), want) and int(dropped) == 0,
          f"dist host world 2 rank {me}: assembled rows differ from the host matrix or peer_dropped {int(dropped)}")
    check(int(peer.sum()) > 0 and mesh.counts["all_to_all"] >= 2, f"dist host world 2 rank {me}: no peer-hot rows")
    out["assemble"] = {"frontier_slots": int(frm_np.sum()), "staged_rows": staged.count,
                       "peer_hot_rows": int(peer.sum()), "peer_rounds": mesh.counts["host_syncs"]}
    # (a), (c): the same batches under both plans, from the same params,
    # after a warm-up batch each, timed in turns (selfless, selfish,
    # selfish, selfless)
    runs = {}
    for name, plan in plans.items():
        st = store if name == "selfless" else DistHostFeatureStore(feats, mesh, plan, miss_budget=1 << 15)
        tr = DistHostTrainer(model=SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                                        generator=torch.Generator().manual_seed(92), device=cuda),
                             fan_out=FAN_OUT, store=st, dedup_last=False)
        tr.train_batches(graph, labels_np, batches[:1], 93)
        runs[name] = {"store": st, "trainer": tr, "ms_per_batch_rounds": []}
    for order in (("selfless", "selfish"), ("selfish", "selfless")):
        for name in order:
            run = runs[name]
            sync()
            mesh.reset_counts()
            t0 = time.perf_counter()
            mets = run["trainer"].train_batches(graph, labels_np, batches[1:], 94)
            sync()
            run["ms_per_batch_rounds"].append((time.perf_counter() - t0) / len(mets) * 1e3)
            run["collectives_per_batch"] = {k: v / len(mets) for k, v in mesh.counts.items()}
            check(all(int(m_["peer_dropped"]) == 0 and np.isfinite(float(m_["loss"])) for m_ in mets),
                  f"dist host world 2 rank {me} {name}: peer_dropped or loss")
            run.update(staged_rows=[m_["feat_miss"] for m_ in mets], stage_ms=[m_["stage_ms"] for m_ in mets],
                       losses=[float(m_["loss"]) for m_ in mets],
                       host_syncs_per_batch=mesh.counts["host_syncs"] / len(mets))
    for name, run in runs.items():
        psum = torch.stack([p.detach().double().sum() for p in run.pop("trainer").model.parameters()]).sum().reshape(1)
        sums = [float(x) for x in mesh.all_gather(psum)]
        check(sums[0] == sums[1], f"dist host world 2 rank {me} {name}: the ranks' params differ ({sums})")
        run["union_hit_rate"] = run.pop("store").union_hit_rate(fr_np[frm_np])
    check(sum(runs["selfless"]["staged_rows"]) < sum(runs["selfish"]["staged_rows"]),
          f"dist host world 2 rank {me}: selfless staged {runs['selfless']['staged_rows']}, "
          f"selfish {runs['selfish']['staged_rows']}")
    out["plans"] = runs
    out["calibrate_ici_gloo_host_Bps"] = calibrate_ici(mesh)
    return out


def two_tier_world4(mesh, caps, num_nodes, f_plan, s_plan, tier) -> dict:
    """One rank of the two_tier_world4_gloo phase (``launch`` spawns four on
    the card over gloo, as the two-tier mesh (2, 2)): each builds the bench
    graph (``num_nodes`` 500,000) from its seed and checks (a) an exchange
    whose every id lies in shard 0, host budget 256 for 4,096 ids a rank:
    lossless, exact, in the 16 rounds the skew implies, two all_to_alls a
    stage a round; (b) the same random ids give the same rows through the
    hierarchical and the flat exchange; (c) a per-rank selfless hot tier
    whose base shards lie about the hot rows: rows hot on a rank of this
    host come back true, rows hot only on the other host as the base's
    lie, cold rows true; (d) the gradient protocol of ``world2_gloo`` (c)
    with the features through the hierarchical store; (e) 4
    ``DistTrainer`` steps at the SAGE bench config (bf16 store, 512 seeds a
    rank) on the ``ShardedGraph`` and the hierarchical store with the
    selfless 20% plan's hot sets (``f_plan``, ``s_plan``) and peer-hot
    rows, 3 timed, with the collectives per axis and the kernel launches
    per step, then 3 steps at a time in turns with the same step through
    the flat exchange on the same axis; (f) one ``DistHostTrainer`` batch
    with host features and
    structure (``tier``'s budgets): rows hot only on the other host are
    staged, ``peer_dropped`` 0, ``struct_remote`` reported, the ranks'
    params equal; (g) ``calibrate_ici`` over the host and the data axes.
    Returns its measures."""
    import numpy as np
    import torch

    from dist_gnn_tpu_torch.cache.cost_model import calibrate_ici
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
    from dist_gnn_tpu_torch.models.sage import SAGE
    from dist_gnn_tpu_torch.parallel import feature_store as dfs
    from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph
    from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
    from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore
    from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer
    from dist_gnn_tpu_torch.sampler import sample_blocks
    from dist_gnn_tpu_torch.training import dist_masked_nll_loss
    from dist_gnn_tpu_torch.training.pipeline import batch_keys

    ax = ("host", "data")
    cuda, n, me = mesh.device, mesh.size, mesh.rank
    H, D = mesh.shape
    on_card = cuda.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    counters = kernel_counters()
    out = {"rank": me, "backend": mesh.backend, "device": str(cuda), "shape": [H, D]}
    t_rank = time.perf_counter()
    arrays, meta = make_synthetic_dataset(
        num_nodes=num_nodes, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=0,
    )
    hg = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"])
    feats = arrays["features"]
    N = hg.num_nodes
    out["data_s"] = time.perf_counter() - t_rank
    # (a) adversarial skew: every id in shard 0, a host budget far below the load
    store = dfs.ShardedFeatureStore(feats, mesh, axis_name=ax, hierarchical=True)
    S = store.shard_size
    L, bh = 4096, 256
    ids_np = np.random.default_rng(10 + me).integers(0, S, L).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(cuda)
    ones = torch.ones(L, dtype=torch.bool, device=cuda)
    sync()
    mesh.reset_counts()
    t0 = time.perf_counter()
    rows, uns = dfs.exchange_gather_hier(store.features, ids, ones, mesh, S, budget_host=bh)
    sync()
    skew_ms = (time.perf_counter() - t0) * 1e3
    c = mesh.all_counts()
    rounds = c["world"]["host_syncs"]
    check(np.array_equal(rows.cpu().numpy(), feats[ids_np]) and int(uns) == 0,
          f"two-tier rank {me}: the skewed hierarchical exchange lost or changed rows")
    check(rounds == -(-L // bh), f"two-tier rank {me}: {rounds} rounds, expected {-(-L // bh)}")
    check(c["host"]["all_to_all"] == c["data"]["all_to_all"] == 2 * rounds and c["world"]["all_to_all"] == 0,
          f"two-tier rank {me}: collectives {c}")
    out["skew"] = {"ids": L, "budget_host": bh, "budget_data": H * bh, "rounds": rounds, "collectives": c,
                   "ms": skew_ms}
    # (b) hierarchical == flat on the same random ids
    q_np = np.random.default_rng(20 + me).integers(0, N, L).astype(np.int32)
    q = torch.from_numpy(q_np).to(cuda)
    mesh.reset_counts()
    rh, uh = store.fetch_local(q, ones)
    c_h = mesh.all_counts()
    rf, uf = dfs.exchange_gather(store.features, q, ones, mesh, S)
    check(torch.equal(rh, rf) and np.array_equal(rh.cpu().numpy(), feats[q_np]) and int(uh) == int(uf) == 0,
          f"two-tier rank {me}: the hierarchical and the flat exchange differ")
    times = {}
    for name, fn in (("hier", lambda: store.fetch_local(q, ones)),
                     ("flat", lambda: dfs.exchange_gather(store.features, q, ones, mesh, S))) * 2:
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync()
        times.setdefault(name, []).append((time.perf_counter() - t0) / 3 * 1e3)
    out["hier_vs_flat"] = {"ids": L, "rows_equal": True, "collectives_hier": c_h, "ms_in_turns": times}
    # (c) peer-hot inside a host: per-rank disjoint hot sets, the base lies about them
    C = min(20_000, N // (2 * n))
    hot = np.random.default_rng(30).permutation(N)[: n * C].reshape(n, C).astype(np.int32)
    lie = feats.copy()
    lie[hot.reshape(-1)] = -777.0
    peer = (me // D) * D + (me + 1) % D  # the other rank of this host
    far = (me + D) % n  # a rank of the other host
    cold = np.setdiff1d(np.arange(N, dtype=np.int32), hot.reshape(-1))
    q2_np = np.concatenate([hot[peer][:1024], hot[far][:1024], hot[me][:256],
                            np.random.default_rng(40 + me).choice(cold, 1024)]).astype(np.int32)
    st = dfs.ShardedFeatureStore(feats, mesh, axis_name=ax, hierarchical=True, hot_ids=hot, peer_hot=True)
    st.features = st.shard_of(lie)
    q2 = torch.from_numpy(q2_np).to(cuda)
    m2 = torch.ones(len(q2_np), dtype=torch.bool, device=cuda)
    mesh.reset_counts()
    r2, u2 = st.fetch_local(q2, m2, budget=st.request_budget_for(len(q2_np)))
    c2 = mesh.all_counts()
    r2 = r2.cpu().numpy()
    host_hot = np.isin(q2_np, hot[(me // D) * D:(me // D + 1) * D].reshape(-1))
    far_only = np.isin(q2_np, hot.reshape(-1)) & ~host_hot
    check(int(u2) == 0 and np.array_equal(r2[host_hot], feats[q2_np[host_hot]]),
          f"two-tier rank {me}: rows hot on this host are not the true rows")
    check(far_only.sum() == 1024 and bool((r2[far_only] == -777.0).all()),
          f"two-tier rank {me}: rows hot only on the other host should come from the base")
    check(np.array_equal(r2[~np.isin(q2_np, hot.reshape(-1))], feats[q2_np[~np.isin(q2_np, hot.reshape(-1))]]),
          f"two-tier rank {me}: cold rows are not the true rows")
    check(c2["data"]["host_syncs"] >= 1 and c2["host"]["host_syncs"] == 0,
          f"two-tier rank {me}: the peer-hot rounds left the host: {c2}")
    out["peer_hot"] = {"ids": len(q2_np), "hot_on_a_host_peer": 1024, "hot_only_on_the_other_host": 1024,
                       "collectives": c2}
    del lie, st
    # (d) the gradient protocol on fixed blocks, features through the hierarchical store
    graph = hg.to_device(cuda)
    seeds = np.random.default_rng(40).choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32)
    blocks = [sample_blocks(graph, torch.from_numpy(seeds[k * BATCH:(k + 1) * BATCH]).to(cuda),
                            torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                            torch.Generator(device=cuda).manual_seed(100 + k), dedup_last=False)[0]
              for k in range(n)]
    labels = torch.from_numpy(arrays["labels"]).to(cuda)
    model = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), dropout=0.0,
                 generator=torch.Generator().manual_seed(41), device=cuda)
    ref = SAGE(100, 256, meta["num_classes"], len(FAN_OUT), dropout=0.0,
               generator=torch.Generator().manual_seed(41), device=cuda)
    mine = blocks[me]
    fr = mine[-1].frontier
    rows, _ = store.fetch_local(fr, mine[-1].frontier_mask, budget=store.request_budget_for(fr.shape[0]))
    lab = labels[torch.from_numpy(seeds[me * BATCH:(me + 1) * BATCH]).to(cuda).long()]
    loss, _ = dist_masked_nll_loss(model, False, mesh, mine, rows, lab, mine[0].seed_mask, None)
    loss.backward()
    grads = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in model.parameters()]))
    loss_dist = float(mesh.all_reduce(loss.detach().reshape(1))[0])
    feats_dev = torch.from_numpy(feats).to(cuda)
    total = 0.0
    for k, blk in enumerate(blocks):
        safe = torch.where(blk[-1].frontier_mask, blk[-1].frontier, 0).long()
        logits = ref(tuple(reversed(blk)), feats_dev[safe], contiguous_first=True)
        lab_k = labels[torch.from_numpy(seeds[k * BATCH:(k + 1) * BATCH]).to(cuda).long()]
        total = total - torch.log_softmax(logits.float(), -1).gather(1, lab_k[:, None].long()).sum()
    total = total / (n * BATCH)
    total.backward()
    total = float(total.detach())
    ref_grads = torch.cat([p.grad.reshape(-1) for p in ref.parameters()])
    loss_err = abs(loss_dist - total) / max(1.0, abs(total))
    off, grad_err = 0, {}
    for name, p in ref.named_parameters():
        grad_err[name] = share_err(grads[off:off + p.numel()], ref_grads[off:off + p.numel()])
        off += p.numel()
    check(loss_err <= LOSS_F32_TOL, f"two-tier rank {me}: dist loss {loss_dist} vs single-device {total}")
    check(all(e <= GRAD_F32_TOL for e in grad_err.values()), f"two-tier rank {me}: gradients {grad_err}")
    out["grad"] = {"loss_dist": loss_dist, "loss_single_device": total, "loss_err": loss_err,
                   "grad_share_err": grad_err}
    del graph, feats_dev, blocks, model, ref, store
    # (e) DistTrainer at the SAGE bench config on the tuple axis
    sg = ShardedGraph.build(hg, mesh, axis_name=ax, hot_ids=s_plan)
    store_bf = dfs.ShardedFeatureStore(torch.from_numpy(feats).to(torch.bfloat16), mesh, axis_name=ax,
                                       hierarchical=True, hot_ids=f_plan, peer_hot=True)
    tr = DistTrainer(model=SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(60), device=cuda),
                     fan_out=FAN_OUT, store=store_bf, sgraph=sg, dedup_last=False, frontier_caps=caps)
    labs = store_bf.shard_of(labels[:, None])
    brng = np.random.default_rng(80)
    batches = [(torch.from_numpy(brng.choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32)).to(cuda),
                torch.ones(n * BATCH, dtype=torch.bool, device=cuda)) for _ in range(4)]
    gen = torch.Generator(device=cuda).manual_seed(70 + me)
    tr.train_step(None, labs, *batches[0], gen)  # warm-up
    sync()
    mesh.reset_counts()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    mets = [tr.train_step(None, labs, s, mk, gen) for s, mk in batches[1:]]
    sync()
    step_ms = (time.perf_counter() - t0) / len(mets) * 1e3
    launches = {k: fn.launches / len(mets) for k, fn in counters.items()}
    coll = {a: {k: v / len(mets) for k, v in cnt.items()} for a, cnt in mesh.all_counts().items()}
    ovf = sum(int(m_["overflow"]) + int(m_["sampler_overflow"]) + int(m_["frontier_overflow"]) for m_ in mets)
    check(ovf == 0 and all(np.isfinite(float(m_["loss"])) for m_ in mets), f"two-tier rank {me}: overflow {ovf}")
    if on_card:  # the step ran through the path's kernels
        ran = {k: launches[k] for k in ("sample_uniform", "gather_rows", "gather_mean", "slot_transpose",
                                        "gather_mean_bwd", "dropout")}
        check(all(v > 0 for v in ran.values()), f"two-tier rank {me}: kernels not launched in the step: {ran}")
    psum = torch.stack([p.detach().double().sum() for p in tr.model.parameters()]).sum().reshape(1)
    sums = [float(x) for x in mesh.all_gather(psum)]
    check(len(set(sums)) == 1, f"two-tier rank {me}: the ranks' params differ after training ({sums})")
    # the same step with the flat exchange on the same axis (peer-hot over
    # the world), timed in turns with the hierarchical one
    store_fl = dfs.ShardedFeatureStore(torch.from_numpy(feats).to(torch.bfloat16), mesh, axis_name=ax,
                                       hot_ids=f_plan, peer_hot=True)
    tr_fl = DistTrainer(model=SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                                   generator=torch.Generator().manual_seed(60), device=cuda),
                        fan_out=FAN_OUT, store=store_fl, sgraph=sg, dedup_last=False, frontier_caps=caps)
    gen_fl = torch.Generator(device=cuda).manual_seed(70 + me)
    tr_fl.train_step(None, labs, *batches[0], gen_fl)  # warm-up
    turns = {"hier": [], "flat": []}
    for name in ("flat", "hier", "hier", "flat"):
        t_, g_ = (tr, gen) if name == "hier" else (tr_fl, gen_fl)
        sync()
        mesh.reset_counts()
        t0 = time.perf_counter()
        for s_, mk_ in batches[1:]:
            t_.train_step(None, labs, s_, mk_, g_)
        sync()
        turns[name].append((time.perf_counter() - t0) / (len(batches) - 1) * 1e3)
        if name == "flat":
            coll_fl = {a: {k: v / (len(batches) - 1) for k, v in cnt.items()} for a, cnt in mesh.all_counts().items()}
    out["train"] = {"steps": len(mets), "ms_per_step": step_ms, "losses": [float(m_["loss"]) for m_ in mets],
                    "collectives_per_step": coll, "launches_per_step": launches,
                    "ms_per_step_in_turns": turns, "flat_exchange_collectives_per_step": coll_fl,
                    "hot_feature_rows": int((store_bf.hot_sorted != INVALID_ID).sum()),
                    "hot_structure_rows": int((sg.hot_sorted != INVALID_ID).sum())}
    del sg, store_bf, tr, store_fl, tr_fl
    # (f) one DistHostTrainer batch, host features and structure, on (2, 2)
    feats32 = np.ascontiguousarray(feats, np.float32)
    labels_np = np.asarray(arrays["labels"], np.int32)
    hstore = DistHostFeatureStore(feats32, mesh, f_plan, miss_budget=tier["feat_miss_budget"], axis_name=ax)
    gstore = DistHostCSCStore(hg, mesh, s_plan, miss_budget=tier["struct_miss_budget"], deg_cap=tier["deg_cap"],
                              axis_name=ax)
    htr = DistHostTrainer(model=SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                                     generator=torch.Generator().manual_seed(92), device=cuda),
                          fan_out=FAN_OUT, store=hstore, gstore=gstore, dedup_last=False)
    hb = [(np.random.default_rng(90).choice(arrays["train_idx"], n * BATCH, replace=False).astype(np.int32),
           np.ones(n * BATCH, bool))]
    s_me, m_me = htr._my_slice(*hb[0])
    _, _, fr_np, frm_np = htr.sample(None, s_me, m_me, batch_keys(95, 0, cuda, me)[0], np.random.default_rng(96))
    staged = hstore.stage(fr_np, frm_np)
    staged.wait()
    host_rows = f_plan[(me // D) * D:(me // D + 1) * D]
    in_host = np.isin(fr_np, host_rows[host_rows != INVALID_ID])
    cross = frm_np & np.isin(fr_np, f_plan[f_plan != INVALID_ID]) & ~in_host
    check(staged.count == int((frm_np & ~in_host).sum()) and int(cross.sum()) > 0,
          f"two-tier rank {me}: staged {staged.count} rows, {int(cross.sum())} hot only on the other host")
    mesh.reset_counts()
    sync()
    t0 = time.perf_counter()
    hm = htr.train_batches(None, labels_np, hb, 93)
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3
    check(int(hm[0]["peer_dropped"]) == 0 and np.isfinite(float(hm[0]["loss"])),
          f"two-tier rank {me}: peer_dropped {int(hm[0]['peer_dropped'])}, loss {float(hm[0]['loss'])}")
    psum = torch.stack([p.detach().double().sum() for p in htr.model.parameters()]).sum().reshape(1)
    sums = [float(x) for x in mesh.all_gather(psum)]
    check(len(set(sums)) == 1, f"two-tier rank {me}: the ranks' params differ after the host-tier batch ({sums})")
    out["dist_host"] = {"ms_batch": host_ms, "loss": float(hm[0]["loss"]),
                        **{k: hm[0][k] for k in ("feat_miss", "struct_miss", "struct_remote", "struct_overflow")},
                        "cross_host_hot_rows_staged": int(cross.sum()), "frontier_staged_rows": staged.count,
                        "collectives": mesh.all_counts()}
    # (g) the all-to-all rate of each axis (gloo through the host: not NVLink)
    out["calibrate_ici_Bps"] = {"host": calibrate_ici(mesh, "host"), "data": calibrate_ici(mesh, "data")}
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    t_script = time.perf_counter()
    from dist_gnn_tpu_torch.cache.builder import build_cache_plan, compute_heats
    from dist_gnn_tpu_torch.cache.cost_model import calibrate, calibrate_host_staging
    from dist_gnn_tpu_torch.cache.policy import structure_space_bytes
    from dist_gnn_tpu_torch.cache.autotune import tune_dist_tier, tune_sampler_for
    from dist_gnn_tpu_torch.dataloading.preprocess import add_random_probs, make_synthetic_dataset
    from dist_gnn_tpu_torch.dataloading.seeds import SeedGenerator
    from dist_gnn_tpu_torch.graph import INVALID_ID, HostGraph
    from dist_gnn_tpu_torch.host_tier import HostCSCStore, HostFeatureStore, assemble_features, sample_staged_hop
    from dist_gnn_tpu_torch.kernels import build
    from dist_gnn_tpu_torch.models.gat import GAT
    from dist_gnn_tpu_torch.models.gcn import GCN
    from dist_gnn_tpu_torch.models.inference import full_graph_inference, full_graph_inference_host
    from dist_gnn_tpu_torch.models import sage as sage_mod
    from dist_gnn_tpu_torch.models.sage import SAGE, contiguous_mean
    from dist_gnn_tpu_torch.ops import dropout as drop_ops
    from dist_gnn_tpu_torch.ops import gat as gat_ops
    from dist_gnn_tpu_torch.ops import gather, prng, sampling, spmm
    from dist_gnn_tpu_torch.ops.hashtable import np_in_sorted
    from dist_gnn_tpu_torch.ops.quantize import dequantize_unpack, quantize_pack
    from dist_gnn_tpu_torch.ops.relabel import unique_and_relabel
    from dist_gnn_tpu_torch.parallel import feature_store as dfs
    from dist_gnn_tpu_torch.parallel.graph_dist import ShardedGraph, sample_neighbors_cached, sample_neighbors_sharded
    from dist_gnn_tpu_torch.parallel.host_dist import DistHostFeatureStore, DistHostTrainer
    from dist_gnn_tpu_torch.parallel.host_struct import DistHostCSCStore
    from dist_gnn_tpu_torch.parallel.inference_dist import dist_full_graph_inference
    from dist_gnn_tpu_torch.entry import dryrun_multichip
    from dist_gnn_tpu_torch.parallel.mesh import Mesh, initialize_distributed, launch, make_mesh
    from dist_gnn_tpu_torch.parallel.trainer_dist import DistTrainer
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks
    from dist_gnn_tpu_torch.scripts import (bench_gather2, bench_gather_mean, bench_gather_rows, bench_k6, bench_k8,
                                            bench_sampler)
    from dist_gnn_tpu_torch.training import HostTierTrainer, Trainer, masked_nll_loss
    from dist_gnn_tpu_torch.training.pipeline import batch_keys
    from dist_gnn_tpu_torch.utils import native
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    def device_ms(fn, kernel_name):
        """Mean device time of one launch of the named kernel while ``fn``
        runs, from the profiler; fails, naming what the profiler did
        record, if it recorded none."""
        kernels, _ = profile_device(fn)
        hits = [v for k, v in kernels.items() if kernel_name in k]
        check(bool(hits), f"the profiler recorded no {kernel_name}: {sorted(k[:70] for k in kernels)[:12]}")
        return sum(ms for ms, _ in hits) / sum(n for _, n in hits)

    def device_ms_per_call(fn, prefix, iters=10):
        """Device ms of one call of ``fn`` summed over the kernels whose name
        holds ``prefix`` (a call may launch several), from the profiler;
        fails if it recorded none."""
        kernels, _ = profile_device(fn, iters=iters)
        hits = [v for k, v in kernels.items() if prefix in k]
        check(bool(hits), f"the profiler recorded no {prefix}: {sorted(k[:70] for k in kernels)[:12]}")
        return sum(ms for ms, _ in hits) / iters

    counters = kernel_counters()

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

    # K6 against its plain version on the card, bit for bit: the three hops
    # of the main path (each hop's seeds are the frontier the hop before
    # produced), without replacement on the request's keys and with
    # replacement on [B, k] keys from Generator(2)
    rgen = torch.Generator().manual_seed(2)
    k6_hops = []
    k6_sum = dict.fromkeys(("ms", "plain_ms", "bound_ms", "device_ms", "queued_ms"), 0.0)
    for i, (blk, kk) in enumerate(zip(blocks, reversed(FAN_OUT))):
        s_hop = blk.seeds
        B = s_hop.shape[0]
        hop = {"hop": i, "B": B, "k": kk}
        for replace in (False, True):
            key = prng.random_keys(rgen, (B, kk), cuda) if replace else hop_keys[i].to(cuda)
            got = sampling.sample_uniform(graph, s_hop, kk, replace, key)
            want = sampling.sample_uniform_plain(graph, s_hop, kk, replace, key)
            torch.cuda.synchronize()
            check(torch.equal(got.ids, want.ids) and torch.equal(got.mask, want.mask),
                  f"K6 hop {i} replace={replace}: differs from sample_uniform_plain")
            if replace:
                hop["replace_valid_slots"] = int(got.mask.sum())
                continue
            # bound: the distinct 32-byte sectors of indices that the taken
            # slots read (at the plain version's positions) and of indptr
            # that the valid seeds' pairs read; every seed and key read
            # once; ids and mask written once
            pos, _ = sampling.plain_positions(graph, s_hop, kk, False, key)
            idx_sectors = int(torch.unique((graph.indices.data_ptr() + 4 * pos[got.mask]) // 32).numel())
            seeds_v = s_hop[s_hop != INVALID_ID].long()
            esz = graph.indptr.element_size()
            ptr_sectors = int(torch.unique(
                (graph.indptr.data_ptr() + esz * torch.cat([seeds_v, seeds_v + 1])) // 32).numel())
            nbytes = (idx_sectors + ptr_sectors) * 32 + B * (4 + 8) + B * kk * 5
            hop.update({
                "valid_slots": int(got.mask.sum()), "indices_sectors": idx_sectors,
                "indptr_sectors": ptr_sectors, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "ms": cuda_time_ms(lambda: sampling.sample_uniform(graph, s_hop, kk, False, key)),
                "device_ms": device_ms(lambda: sampling.sample_uniform(graph, s_hop, kk, False, key),
                                       "sample_uniform"),
                "queued_ms": bench_k6.queued_ms(lambda: sampling.sample_uniform(graph, s_hop, kk, False, key)),
                "plain_ms": cuda_time_ms(lambda: sampling.sample_uniform_plain(graph, s_hop, kk, False, key),
                                         iters=3, warmup=1),
            })
            for key_ in k6_sum:
                k6_sum[key_] += hop[key_] or 0.0
        k6_hops.append(hop)
    # Which K6 kernel a call without replacement runs: csrc/sampling.cu
    # takes the packed one at kQueueSlots slots or more, the in-place one
    # below (and with replacement); the profiler names the one it ran
    def k6_kernel(s_t, kk, replace):
        return "packed" if not replace and s_t.shape[0] * kk >= K6_PACKED_SLOTS else "in_place"

    def k6_ran(fn, which):
        kernels, _ = profile_device(fn, iters=1)
        ran = sorted({"packed" if "sample_uniform_packed" in name else "in_place"
                      for name in kernels if "sample_uniform" in name})
        check(ran == [which], f"K6 ran {ran}, not the {which} kernel: {sorted(kernels)[:6]}")

    # rows of degree 0, 1, k, k + 1, 2^b, 2^b + 1 and a hub of 100,000, each
    # seeded, among random rows and padded seeds, under int32 and int64
    # indptr; the seeds once (in-place kernel) and tiled past kQueueSlots
    # slots (packed kernel without replacement); an edgeless graph
    # launches nothing
    erng = np.random.default_rng(3)
    ek = 5
    degs = [0, 1, ek, ek + 1, 8, 9, 32, 33, 128, 129, 100_000] + list(erng.integers(0, 41, 500))
    n_e = len(degs) + 20
    e_dst = np.repeat(np.arange(len(degs)), degs)
    ehg = HostGraph.from_coo(erng.integers(0, n_e, e_dst.shape[0]), e_dst, n_e)
    e_seeds = np.concatenate([np.arange(len(degs)), erng.integers(0, n_e, 1500)]).astype(np.int32)
    e_seeds[::7] = INVALID_ID
    e_tiles = -(-K6_PACKED_SLOTS // (e_seeds.shape[0] * ek))
    edge_rows = []
    for indptr_dtype in (np.int32, np.int64):
        eg = HostGraph(indptr=ehg.indptr.astype(indptr_dtype), indices=ehg.indices).to_device(cuda)
        for tiles in (1, e_tiles):
            e_seeds_t = torch.from_numpy(np.tile(e_seeds, tiles)).to(cuda)
            B_e = e_seeds_t.shape[0]
            for replace in (False, True):
                key = prng.random_keys(rgen, (B_e, ek) if replace else (B_e,), cuda)
                got = sampling.sample_uniform(eg, e_seeds_t, ek, replace, key)
                want = sampling.sample_uniform_plain(eg, e_seeds_t, ek, replace, key)
                torch.cuda.synchronize()
                check(torch.equal(got.ids, want.ids) and torch.equal(got.mask, want.mask),
                      f"K6 edge rows x{tiles}, {indptr_dtype.__name__} indptr, replace={replace}: "
                      "differs from plain")
                which = k6_kernel(e_seeds_t, ek, replace)
                k6_ran(lambda: sampling.sample_uniform(eg, e_seeds_t, ek, replace, key), which)
                edge_rows.append({"indptr": indptr_dtype.__name__, "B": B_e, "replace": replace,
                                  "kernel": which, "valid_slots": int(got.mask.sum())})
    check(e_tiles > 1 and sum(r["kernel"] == "packed" for r in edge_rows) == 2,
          "K6 edge rows: the packed kernel ran on no tiled case")
    # seeds that are all the longest row: the walk on the largest domain, 64
    # of them (in-place kernel) and as many as make kQueueSlots slots (packed
    # kernel without replacement)
    hub_node = int(np.argmax(np.diff(hg.indptr.astype(np.int64))))
    for B_h in (64, -(-K6_PACKED_SLOTS // 15)):
        hub_seeds = torch.full((B_h,), hub_node, dtype=torch.int32, device=cuda)
        for replace in (False, True):
            key = prng.random_keys(rgen, (B_h, 15) if replace else (B_h,), cuda)
            got = sampling.sample_uniform(graph, hub_seeds, 15, replace, key)
            want = sampling.sample_uniform_plain(graph, hub_seeds, 15, replace, key)
            torch.cuda.synchronize()
            check(torch.equal(got.ids, want.ids) and torch.equal(got.mask, want.mask),
                  f"K6 hub row x{B_h}, replace={replace}: differs from sample_uniform_plain")
            which = k6_kernel(hub_seeds, 15, replace)
            k6_ran(lambda: sampling.sample_uniform(graph, hub_seeds, 15, replace, key), which)
            edge_rows.append({"hub_row": True, "B": B_h, "replace": replace, "kernel": which,
                              "valid_slots": int(got.mask.sum())})
    # one capture of the last hop, replayed on new seeds and keys in its buffers
    s_buf, k_buf = blocks[-1].seeds.clone(), hop_keys[-1].to(cuda)
    sampling.sample_uniform(graph, s_buf, FAN_OUT[0], False, k_buf)
    torch.cuda.synchronize()
    k6_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(k6_graph):
        k6_captured = sampling.sample_uniform(graph, s_buf, FAN_OUT[0], False, k_buf)
    new_seeds = torch.randint(0, hg.num_nodes, s_buf.shape, dtype=torch.int32, device=cuda)
    new_seeds[::9] = INVALID_ID
    new_keys = prng.random_keys(rgen, k_buf.shape, cuda)
    s_buf.copy_(new_seeds)
    k_buf.copy_(new_keys)
    k6_graph.replay()
    want = sampling.sample_uniform_plain(graph, new_seeds, FAN_OUT[0], False, new_keys)
    torch.cuda.synchronize()
    check(torch.equal(k6_captured.ids, want.ids) and torch.equal(k6_captured.mask, want.mask),
          "K6 captured in a CUDA graph: the replay differs from sample_uniform_plain")
    del k6_graph, k6_captured
    empty_g = HostGraph(indptr=np.zeros(11, np.int32), indices=np.zeros(0, np.int32)).to_device(cuda)
    before = sampling.sample_uniform.launches
    got = sampling.sample_uniform(empty_g, torch.arange(4, dtype=torch.int32, device=cuda), 3, False,
                                  torch.zeros(4, dtype=torch.int64, device=cuda))
    check(bool((got.ids == INVALID_ID).all()) and not bool(got.mask.any()), "K6 on an edgeless graph")
    check(sampling.sample_uniform.launches == before, "K6 launched for an edgeless graph")

    # one sample_blocks call: kernels, device ms, wall ms, event ms
    sgen = torch.Generator(device=cuda).manual_seed(12)
    cuda_keys = [k.to(cuda) for k in hop_keys]
    sample_stage = {
        "injected_keys": bench_sampler.time_group(
            lambda: sample_blocks(graph, seeds, mask, FAN_OUT, False, cuda_keys, dedup_last=False),
            iters=10, prof_iters=10),
        "generator": bench_sampler.time_group(
            lambda: sample_blocks(graph, seeds, mask, FAN_OUT, False, sgen, dedup_last=False),
            iters=10, prof_iters=10),
    }
    k6 = {"name": "sample_uniform", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/sampling.cu",
          "replaces": "none: no Pallas counterpart; JAX's jnp sampler dist_gnn_tpu/ops/sampling.py:305",
          "max_abs_err": 0.0, **k6_sum, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "kernel", "kernel": "K6 sample_uniform", "exact": True,
          "times_are": "sums over the three hops of one request (replace=False)", "hops": k6_hops,
          "edge_rows": edge_rows, "edgeless_graph_launches": 0, "cuda_graph_replay_equal": True,
          "library": "none: no one PyTorch call samples a CSC graph",
          "sample_blocks": sample_stage, **k6, **card})

    # ---- 3b. weighted (biased) sampling: alias tables, K7 and K8 ----------
    # the bench graph with |N(0, 1)| weights: add_random_probs(E, 0) is what
    # make_synthetic_dataset(seed=0, with_probs=True) attaches to this graph
    probs_np = add_random_probs(hg.num_edges, 0)
    hg_w = HostGraph(indptr=hg.indptr, indices=hg.indices, probs=probs_np)
    indptr64 = hg.indptr.astype(np.int64)
    t0 = time.perf_counter()
    ap_np, ai_np = native.build_alias(hg.indptr, probs_np)
    alias_ms = (time.perf_counter() - t0) * 1e3
    # the native tables equal the numpy plain version's, bit for bit, on the
    # first 2,000 rows and the longest (each row's table is its own)
    deg64 = np.diff(indptr64)
    chk_rows = np.concatenate([np.arange(2000), [int(np.argmax(deg64))]]).astype(np.int32)
    sp, _, spr = native.extract_subcsc(chk_rows, hg.indptr, hg.indices, probs_np)
    pp, pa = native.build_alias_plain(sp, spr)
    sel_e = np.concatenate([np.arange(indptr64[r], indptr64[r + 1]) for r in chk_rows])
    check(np.array_equal(pp.view(np.int32), ap_np[sel_e].view(np.int32)) and np.array_equal(pa, ai_np[sel_e]),
          "alias tables: native differs from the numpy plain version")
    probs_dev = torch.from_numpy(probs_np).to(cuda)
    graph_k7 = dataclasses.replace(graph, probs=probs_dev)  # weighted, no tables: K7
    graph_w = dataclasses.replace(graph_k7, alias_prob=torch.from_numpy(ap_np).to(cuda),
                                  alias_idx=torch.from_numpy(ai_np).to(cuda))  # K8
    # HostGraph.from_coo's native build_csc against its numpy version, on
    # the weighted bench graph's edges in a random order: equal arrays
    perm = np.random.default_rng(1).permutation(hg.num_edges)
    coo = (np.repeat(np.arange(hg.num_nodes, dtype=np.int32), deg64)[perm], hg.indices[perm], probs_np[perm])
    del perm
    t0 = time.perf_counter()
    csc_native = native.build_csc(coo[0], coo[1], hg.num_nodes, coo[2])
    csc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    csc_plain = native.build_csc_plain(coo[0], coo[1], hg.num_nodes, coo[2])
    csc_plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(csc_native, csc_plain)),
          "build_csc: native differs from the numpy version")
    del coo, csc_native, csc_plain
    emit({"phase": "alias_tables", "num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
          "max_degree": int(deg64.max()), "zero_weight_edges": int((probs_np == 0).sum()),
          "build_alias_host_ms": alias_ms, "rows_checked_against_plain": len(chk_rows),
          "edges_checked": len(sel_e), "exact": True,
          "build_csc_host_ms": csc_ms, "build_csc_numpy_ms": csc_plain_ms, "build_csc_equal": True, **card})

    def gumbel_sorted(w_row, bits_row):
        """A row's Gumbel keys (the plain versions' arithmetic), sorted
        descending, as float32 numpy."""
        w_t = torch.from_numpy(np.asarray(w_row, np.float32))
        return torch.sort(sampling.gumbel_keys(bits_row.cpu(), w_t, torch.ones_like(w_t, dtype=torch.bool)),
                          descending=True).values.numpy()

    def near_tie(keys_sorted, k):
        """Whether the k-th and (k+1)-th keys lie within 2 ulp: the only
        rows where the card's log may reorder a pick."""
        if len(keys_sorted) <= k or not np.isfinite(keys_sorted[k]):
            return False
        a, b = keys_sorted[k - 1], keys_sorted[k]
        return bool(abs(a - b) <= 2 * np.spacing(np.float32(abs(a))))

    def compare_weighted(name, got, want, tie_ok):
        """Ids and mask equal, except rows ``tie_ok(row)`` names near-ties;
        returns their count."""
        bad = ((got.ids != want.ids) | (got.mask != want.mask)).any(1).nonzero().flatten().tolist()
        for r in bad:
            check(tie_ok is not None and tie_ok(r), f"{name}: row {r} differs from the plain version")
        check(int(torch.as_tensor(got.overflow)) == int(torch.as_tensor(want.overflow)),
              f"{name}: overflow {int(torch.as_tensor(got.overflow))} vs plain {int(torch.as_tensor(want.overflow))}")
        return len(bad)

    def row_span(g_ip, seed):
        lo, hi = int(g_ip[seed]), int(g_ip[seed + 1])
        return lo, hi - lo

    def k7_tie(g_ip, g_probs, seeds_np, row_keys, k):
        def ok(r):
            if seeds_np[r] == INVALID_ID:
                return False
            lo, d = row_span(g_ip, seeds_np[r])
            bits = prng.mix32(row_keys[r].cpu() ^ prng.mix32(torch.arange(d)))
            return near_tie(gumbel_sorted(g_probs[lo:lo + d], bits), k)
        return ok

    def k8_tie(g_ip, g_probs, seeds_np, gum, k):
        def ok(r):
            if seeds_np[r] == INVALID_ID:
                return False
            lo, d = row_span(g_ip, seeds_np[r])
            return d <= 2 * k and near_tie(gumbel_sorted(g_probs[lo:lo + d], gum[r, :d]), k)
        return ok

    def alias_key_set(B, kk, replace, gen):
        bits = prng.random_keys(gen, (2, B, kk if replace else 4 * kk), cuda)
        return bits if replace else (bits, prng.random_keys(gen, (B, 2 * kk), cuda))

    # K7 and K8 at edge shapes: degrees 0, 1, k, 2k, 2k + 1, 31-33, a hub
    # of 100,000, an all-zero-weight row, a tenth of the weights 0, padded
    # seeds; K7's cut: 1023, 1024 and 1025 (each side of its short-row limit
    # and of a slice warp's least range), a 40,000-edge row of many slices
    # with two slices' worth of zero weights, and the hub repeated as 20
    # seeds; int32 and int64 indptr; both modes of each
    wrng = np.random.default_rng(8)
    wgen = torch.Generator().manual_seed(9)
    w_edge_rows, w_ties = [], {"K7": 0, "K8": 0}
    for kk in (5, 10, 15, 40):
        degs = [0, 1, kk, 2 * kk, 2 * kk + 1, 31, 32, 33, 100_000, 50, 1023, 1024, 1025, 40_000] \
            + list(wrng.integers(0, 80, 2000))
        n_e = len(degs) + 10
        e_dst = np.repeat(np.arange(len(degs)), degs)
        e_w = np.abs(wrng.standard_normal(len(e_dst))).astype(np.float32)
        e_w[wrng.random(len(e_w)) < 0.1] = 0
        e_ip = np.concatenate([[0], np.cumsum(degs)])
        e_w[e_ip[9]:e_ip[10]] = 0  # all zero
        e_w[e_ip[13] + 1024:e_ip[13] + 3072] = 0  # whole slices of zero weights
        ehg = HostGraph.from_coo(wrng.integers(0, n_e, len(e_dst)), e_dst, n_e, probs=e_w)
        e_seeds = np.concatenate([np.arange(len(degs)), wrng.integers(0, n_e, 3000), np.full(20, 8)]).astype(np.int32)
        e_seeds[::7] = INVALID_ID
        e_st = torch.from_numpy(e_seeds).to(cuda)
        B = len(e_seeds)
        for ip_dtype in (np.int32, np.int64):
            eg = HostGraph(indptr=ehg.indptr.astype(ip_dtype), indices=ehg.indices,
                           probs=ehg.probs).to_device(cuda, with_alias=True)
            ip_np = ehg.indptr.astype(np.int64)
            for replace in (False, True):
                key = prng.random_keys(wgen, (B, kk) if replace else (B,), cuda)
                n7 = compare_weighted(f"K7 edge k={kk} {ip_dtype.__name__} replace={replace}",
                                      sampling.sample_biased(eg, e_st, kk, replace, key),
                                      sampling.sample_biased_plain(eg, e_st, kk, replace, key),
                                      None if replace else k7_tie(ip_np, ehg.probs, e_seeds, key, kk))
                akey = alias_key_set(B, kk, replace, wgen)
                got8 = sampling.sample_biased_alias(eg, e_st, kk, replace, akey)
                n8 = compare_weighted(f"K8 edge k={kk} {ip_dtype.__name__} replace={replace}", got8,
                                      sampling.sample_biased_alias_plain(eg, e_st, kk, replace, akey),
                                      None if replace else k8_tie(ip_np, ehg.probs, e_seeds, akey[1].cpu(), kk))
                torch.cuda.synchronize()
                w_ties["K7"] += n7
                w_ties["K8"] += n8
                w_edge_rows.append({"k": kk, "indptr": ip_dtype.__name__, "replace": replace,
                                    "near_tie_rows_k7": n7, "near_tie_rows_k8": n8,
                                    "k8_overflow": int(got8.overflow)})
    # K7 past its shared-memory chunk table: a row of 400,000 edges (1,563
    # chunks, above the long-row kernel's 1,536 in shared memory, so with
    # replacement its sums go to the workspace), beside rows of 100,000,
    # 3,000, 1,025 and fewer, the long row as 6 more seeds; then the same
    # graph with max_degree understated, at 1,024 (every row to the row
    # kernel) and at 2,048 (the 400,000-edge row past its workspace): a row
    # longer than max_degree promised stays exact; both modes and indptr dtypes
    big_degs = [400_000, 100_000, 3000, 1025, 1024, 300, 5, 0] + list(wrng.integers(0, 80, 40))
    n_b = len(big_degs) + 4
    b_dst = np.repeat(np.arange(len(big_degs)), big_degs)
    b_w = np.abs(wrng.standard_normal(len(b_dst))).astype(np.float32)
    b_w[wrng.random(len(b_w)) < 0.1] = 0
    bhg = HostGraph.from_coo(wrng.integers(0, n_b, len(b_dst)), b_dst, n_b, probs=b_w)
    b_seeds = np.concatenate([np.arange(len(big_degs)), np.zeros(6, np.int64),
                              wrng.integers(0, n_b, 30)]).astype(np.int32)
    b_seeds[5::9] = INVALID_ID
    b_st = torch.from_numpy(b_seeds).to(cuda)
    big_rows = {"degrees": [400_000, 100_000, 3000, 1025, 1024], "max_degree": bhg.max_degree}
    for replace in (False, True):
        key = prng.random_keys(wgen, (len(b_seeds), 15) if replace else (len(b_seeds),), cuda)
        bg = bhg.to_device(cuda)
        want = sampling.sample_biased_plain(bg, b_st, 15, replace, key)
        n_big = 0
        for ip_dtype in (np.int32, np.int64):
            bg = HostGraph(indptr=bhg.indptr.astype(ip_dtype), indices=bhg.indices, probs=bhg.probs).to_device(cuda)
            for md in (bhg.max_degree, 1024, 2048):
                n_big += compare_weighted(
                    f"K7 400,000-edge row {ip_dtype.__name__} max_degree={md} replace={replace}",
                    sampling.sample_biased(dataclasses.replace(bg, max_degree=md), b_st, 15, replace, key), want,
                    None if replace else k7_tie(bhg.indptr.astype(np.int64), bhg.probs, b_seeds, key, 15))
        check(bool(want.mask[0].any()), f"K7 400,000-edge row replace={replace}: took nothing")
        w_ties["K7"] += n_big
        big_rows[f"{'replace_' if replace else ''}near_tie_rows"] = n_big
    torch.cuda.synchronize()
    for fn in (sampling.sample_biased, sampling.sample_biased_alias):  # an edgeless graph launches nothing
        before = fn.launches
        eg0 = HostGraph(indptr=np.zeros(5, np.int32), indices=np.zeros(0, np.int32),
                        probs=np.zeros(0, np.float32)).to_device(cuda, with_alias=True)
        got = fn(eg0, torch.arange(3, dtype=torch.int32, device=cuda), 4, False, torch.Generator(device=cuda))
        check(not bool(got.mask.any()) and fn.launches == before, f"{fn.__name__} on an edgeless graph")

    # the main path's hops: a weighted request's three hop seed sets
    blocks_w, _ = sample_blocks(graph_w, seeds, mask, FAN_OUT, False,
                                torch.Generator(device=cuda).manual_seed(13), dedup_last=False)
    # positive-weight (row, neighbour) pairs, to show no zero-weight edge is drawn
    edge_row = torch.repeat_interleave(torch.arange(hg.num_nodes, device=cuda),
                                       torch.from_numpy(deg64).to(cuda))
    pos_pairs = torch.unique(edge_row[probs_dev > 0] * hg.num_nodes + graph.indices[probs_dev > 0].long())

    def positive_only(s_hop, out):
        rows = s_hop.long()[:, None].expand_as(out.ids)[out.mask]
        pair = rows * hg.num_nodes + out.ids[out.mask].long()
        idx = torch.clamp(torch.searchsorted(pos_pairs, pair), max=pos_pairs.numel() - 1)
        return bool((pos_pairs[idx] == pair).all())

    sectors, span_sectors = bench_k8.sectors, bench_k8.span_sectors

    rkgen = torch.Generator(device=cuda).manual_seed(14)
    k7_hops, k8_hops = [], []
    k7_sum = dict.fromkeys(("ms", "plain_ms", "bound_ms", "device_ms", "replace_ms", "replace_device_ms"), 0.0)
    k8_sum = dict.fromkeys(("ms", "plain_ms", "bound_ms", "device_ms", "replace_ms", "replace_device_ms",
                            "replace_bound_ms", "bound_all_draws_ms"), 0.0)
    ip_ptr, ip_sz = graph.indptr.data_ptr(), graph.indptr.element_size()
    for i, (blk, kk) in enumerate(zip(blocks_w, reversed(FAN_OUT))):
        s_hop = blk.seeds
        B = s_hop.shape[0]
        s_np = s_hop.cpu().numpy()
        valid = s_hop != INVALID_ID
        safe_s = torch.where(valid, s_hop, 0).long()
        lo = graph.indptr[safe_s].long()
        dg = torch.where(valid, graph.indptr[safe_s + 1].long() - lo, 0)
        ptr_sec = sectors(ip_ptr, ip_sz, torch.cat([safe_s[valid], safe_s[valid] + 1]))
        # K7: both modes checked and timed
        keys7 = {}
        for replace in (True, False):
            key7 = keys7[replace] = prng.random_keys(rkgen, (B, kk) if replace else (B,), cuda)
            got7 = sampling.sample_biased(graph_k7, s_hop, kk, replace, key7)
            n7 = compare_weighted(f"K7 hop {i} replace={replace}", got7,
                                  sampling.sample_biased_plain(graph_k7, s_hop, kk, replace, key7),
                                  None if replace else k7_tie(indptr64, probs_np, s_np, key7, kk))
            check(positive_only(s_hop, got7), f"K7 hop {i} replace={replace}: drew a zero-weight edge")
        pos7, m7 = sampling.sample_biased_positions(graph_k7, s_hop, kk, False, key7)
        bytes7 = (span_sectors(probs_dev.data_ptr(), 4, lo[valid], dg[valid])
                  + sectors(graph.indices.data_ptr(), 4, pos7[m7]) + ptr_sec) * 32 + B * (4 + 8) + B * kk * 5
        hop7 = {"hop": i, "B": B, "k": kk, "near_tie_rows": n7, "valid_slots": int(got7.mask.sum()),
                "edges_read": int(dg.sum()), "bytes": bytes7, "bound_ms": bytes7 / HBM_BYTES_PER_S * 1e3,
                "ms": cuda_time_ms(lambda: sampling.sample_biased(graph_k7, s_hop, kk, False, key7)),
                "device_ms": device_ms_per_call(lambda: sampling.sample_biased(graph_k7, s_hop, kk, False, key7),
                                                "k7_"),
                "replace_ms": cuda_time_ms(lambda: sampling.sample_biased(graph_k7, s_hop, kk, True, keys7[True])),
                "replace_device_ms": device_ms_per_call(
                    lambda: sampling.sample_biased(graph_k7, s_hop, kk, True, keys7[True]), "k7_"),
                "plain_ms": cuda_time_ms(lambda: sampling.sample_biased_plain(graph_k7, s_hop, kk, False, key7),
                                         iters=3, warmup=1)}
        # K8: both modes checked and timed
        keys8 = {}
        for replace in (True, False):
            key8 = keys8[replace] = alias_key_set(B, kk, replace, rkgen)
            got8 = sampling.sample_biased_alias(graph_w, s_hop, kk, replace, key8)
            n8 = compare_weighted(f"K8 hop {i} replace={replace}", got8,
                                  sampling.sample_biased_alias_plain(graph_w, s_hop, kk, replace, key8),
                                  None if replace else k8_tie(indptr64, probs_np, s_np, key8[1].cpu(), kk))
            check(positive_only(s_hop, got8), f"K8 hop {i} replace={replace}: drew a zero-weight edge")
        # what K8's function reads (bench_k8.k8_bytes): a short row's weights
        # and its keys at positive weights; a long row's bit pairs, alias_prob
        # and (where rejected) alias_idx for its draws up to its k-th first
        # occurrence (bytes_all_draws: all 4k of them)
        b8 = bench_k8.k8_bytes(graph_w, s_hop, kk, False, key8)
        b8r = bench_k8.k8_bytes(graph_w, s_hop, kk, True, keys8[True])

        def k8_call(r):
            return lambda: sampling.sample_biased_alias(graph_w, s_hop, kk, r, keys8[r])

        hop8 = {"hop": i, "B": B, "k": kk, "near_tie_rows": n8, "valid_slots": int(got8.mask.sum()),
                "dense_rows": b8["short_rows"], "sparse_rows": b8["drawn_rows"], "overflow": int(got8.overflow),
                "keys_read": b8["keys_read"], "draws": b8["draws_all"], "draws_needed": b8["draws_needed"],
                "alias_idx_reads": b8["alias_idx_reads"], "bytes": b8["bytes"],
                "bytes_all_draws": b8["bytes_all_draws"], "bound_ms": b8["bound_ms"],
                "bound_all_draws_ms": b8["bound_all_draws_ms"],
                "ms": cuda_time_ms(k8_call(False)),
                "device_ms": device_ms(k8_call(False), "sample_biased_alias_kernel"),
                "replace_bytes": b8r["bytes"], "replace_bound_ms": b8r["bound_ms"],
                "replace_ms": cuda_time_ms(k8_call(True)),
                "replace_device_ms": device_ms(k8_call(True), "sample_biased_alias_kernel"),
                "plain_ms": cuda_time_ms(lambda: sampling.sample_biased_alias_plain(graph_w, s_hop, kk, False, key8),
                                         iters=3, warmup=1)}
        torch.cuda.synchronize()
        for acc, hop in ((k7_sum, hop7), (k8_sum, hop8)):
            for key_ in acc:
                check(hop[key_] is not None, f"hop {i}: no {key_}")
                acc[key_] += hop[key_]
        k7_hops.append(hop7)
        k8_hops.append(hop8)
    # K7 on a hop whose 64 seeds are all the longest row (226,746 edges), both
    # modes: its time should follow its 14.5M edges, not its longest row.
    # Bound: the row's weights read once (its sectors), the picks' indices,
    # seeds, keys and outputs; edge_weights_ms: every edge's weight read
    # from memory, as if no seed repeated
    hub_node = int(np.argmax(deg64))
    s_hub = torch.full((64,), hub_node, dtype=torch.int32, device=cuda)
    hub_lo = graph.indptr[s_hub.long()].long()
    hub_dg = graph.indptr[s_hub.long() + 1].long() - hub_lo
    k7_hub = {"B": 64, "k": 15, "edges": int(hub_dg.sum()), "longest_row": int(deg64.max())}
    for replace in (False, True):
        key_h = prng.random_keys(rkgen, (64, 15) if replace else (64,), cuda)
        got_h = sampling.sample_biased(graph_k7, s_hub, 15, replace, key_h)
        n_h = compare_weighted(f"K7 all-hub hop replace={replace}", got_h,
                               sampling.sample_biased_plain(graph_k7, s_hub, 15, replace, key_h),
                               None if replace else k7_tie(indptr64, probs_np, s_hub.cpu().numpy(), key_h, 15))
        check(positive_only(s_hub, got_h), f"K7 all-hub hop replace={replace}: drew a zero-weight edge")
        tag = "replace_" if replace else ""
        k7_hub[f"{tag}near_tie_rows"] = n_h
        k7_hub[f"{tag}ms"] = cuda_time_ms(lambda: sampling.sample_biased(graph_k7, s_hub, 15, replace, key_h))
        k7_hub[f"{tag}device_ms"] = device_ms_per_call(
            lambda: sampling.sample_biased(graph_k7, s_hub, 15, replace, key_h), "k7_")
        if not replace:
            pos_h, m_h = sampling.sample_biased_positions(graph_k7, s_hub, 15, False, key_h)
            hub_bytes = (span_sectors(probs_dev.data_ptr(), 4, hub_lo[:1], hub_dg[:1])
                         + sectors(graph.indices.data_ptr(), 4, pos_h[m_h])
                         + sectors(ip_ptr, ip_sz, torch.tensor([hub_node, hub_node + 1], device=cuda))) * 32 \
                + 64 * (4 + 8) + 64 * 15 * 5
            k7_hub["bytes"] = hub_bytes
            k7_hub["bound_ms"] = hub_bytes / HBM_BYTES_PER_S * 1e3
            k7_hub["edge_weights_ms"] = k7_hub["edges"] * 4 / HBM_BYTES_PER_S * 1e3
    # K8 on bench_k8's all_hub, shortfall (every row short of k: all 4k
    # draws read, overflow counted) and k40 (the shared-memory set) cases,
    # both modes, against the plain version: ids, mask and overflow
    k8_cases = {}
    for name, (g8, s8, kk) in bench_k8.cases(cuda, hg, probs_np, graph_w, [b.seeds for b in blocks_w]).items():
        if not name.startswith("hop"):
            for replace in (False, True):
                key8 = alias_key_set(s8.shape[0], kk, replace, rkgen)
                got8 = sampling.sample_biased_alias(g8, s8, kk, replace, key8)
                tie8 = None if replace or g8 is not graph_w else \
                    k8_tie(indptr64, probs_np, s8.cpu().numpy(), key8[1].cpu(), kk)
                n8 = compare_weighted(f"K8 {name} replace={replace}", got8,
                                      sampling.sample_biased_alias_plain(g8, s8, kk, replace, key8), tie8)
                k8_cases[f"{name}_{'replace' if replace else 'distinct'}"] = {
                    "B": s8.shape[0], "k": kk, "near_tie_rows": n8, "valid_slots": int(got8.mask.sum()),
                    "overflow": int(got8.overflow)}
    check(k8_cases["shortfall_distinct"]["overflow"] > 0, "K8 shortfall case: no row fell short")
    # no K7 or K8 call synchronizes: a hop with rows above K7's short-row
    # limit (a workspace, three kernels), both modes, under the sync debug mode
    s_sync, k_sync = blocks_w[1].seeds, tuple(reversed(FAN_OUT))[1]
    sync_keys = {r: prng.random_keys(rkgen, (s_sync.shape[0], k_sync) if r else (s_sync.shape[0],), cuda)
                 for r in (False, True)}
    sync_keys8 = {r: alias_key_set(s_sync.shape[0], k_sync, r, rkgen) for r in (False, True)}
    synced = {}
    for name, call in (("K7", lambda r: sampling.sample_biased(graph_k7, s_sync, k_sync, r, sync_keys[r])),
                       ("K8", lambda r: sampling.sample_biased_alias(graph_w, s_sync, k_sync, r, sync_keys8[r]))):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for r in (False, True):
                call(r)
            synced[name] = None
        except RuntimeError as err:
            synced[name] = str(err)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check(synced[name] is None, f"a {name} call synchronized: {synced[name]}")
    k7 = {"name": "sample_biased", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/sampling.cu",
          "replaces": "none: no Pallas counterpart; JAX's jnp sampler dist_gnn_tpu/ops/sampling.py:671",
          "max_abs_err": 0.0, **k7_sum, "bound_by": "bytes", "library_ms": None,
          "launches_count": "sample_biased calls; a call launches 1 kernel when graph.max_degree <= 1024 "
          "(the host tier's staged rows, deg_cap 128), else 3 without replacement and 2 with it; "
          "device_ms sums every kernel of a call",
          "hops": [{key_: h[key_] for key_ in ("hop", "B", "k", "edges_read", "ms", "device_ms", "bound_ms",
                                               "replace_ms", "replace_device_ms")} for h in k7_hops],
          "all_hub": k7_hub}
    k8 = {"name": "sample_biased_alias", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/sampling.cu",
          "replaces": "none: no Pallas counterpart; JAX's jnp sampler dist_gnn_tpu/ops/sampling.py:764",
          "max_abs_err": 0.0, **k8_sum, "bound_by": "bytes", "library_ms": None,
          "hops": [{key_: h[key_] for key_ in ("hop", "B", "k", "ms", "device_ms", "bound_ms", "bytes_all_draws",
                                               "replace_ms", "replace_device_ms", "replace_bound_ms")}
                   for h in k8_hops]}
    emit({"phase": "kernels_biased", "times_are": "sums over the three hops of one weighted request "
          "(ms, device_ms, plain_ms without replacement; replace_ms, replace_device_ms with it; both modes "
          "checked)", "k7_hops": k7_hops, "k8_hops": k8_hops, "k8_cases": k8_cases,
          "edge_rows": w_edge_rows, "k7_big_rows": big_rows, "near_tie_rows": w_ties, "exact_but_near_ties": True,
          "zero_weight_edges_drawn": 0, "library": "none: no one PyTorch call samples a weighted CSC graph",
          "k7_all_hub": k7_hub, "k7_synchronized": False, "k8_synchronized": False,
          "k7": {k: k7[k] for k in ("ms", "plain_ms", "bound_ms", "device_ms", "replace_ms", "replace_device_ms")},
          "k8": {k: k8[k] for k in k8_sum}, **card})

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
    # a table 4 bytes off 16-byte alignment (4-byte loads, 16-byte stores),
    # one-byte rows of 13 bytes, a last run shorter than a warp's, ids
    # outside the table (clamped)
    base = torch.randn(5000 * 64 + 1, device=cuda)
    k1_cases = [("f32_offset_4_bytes", base[1:].view(5000, 64)),
                ("uint8_13_bytes", torch.randint(0, 255, (1000, 13), device=cuda, dtype=torch.uint8))]
    for label, tab in k1_cases:
        for n_idx in (1, 333, 1001):
            idx = torch.randint(-3, tab.shape[0] + 3, (n_idx,), device=cuda, dtype=torch.int32)
            check(torch.equal(gather.gather_rows(tab, idx), tab[idx.long().clamp(0, tab.shape[0] - 1)]),
                  f"K1 {label}, L={n_idx}")
    del base
    # K1 beside K2 and index_select at the main path's shape and the gather
    # bench's, in bf16 and f32: bench_gather_rows.measure checks each equal
    # to table[idx] and times them in turns; bound = the distinct rows read
    # once, the ids, the output written once
    bgen = torch.Generator(device=cuda).manual_seed(7)
    bench_bf16 = torch.randn((BENCH_N, BENCH_F), generator=bgen, device=cuda).to(torch.bfloat16)
    bench_idx = torch.randint(0, BENCH_N, (BENCH_L,), generator=bgen, device=cuda, dtype=torch.int32)
    gather_inputs = {"main_path_bf16": (features, safe), "main_path_f32": (features32, safe),
                     "bench_bf16": (bench_bf16, bench_idx), "bench_f32": (bench_bf16.float(), bench_idx)}
    gather_timed = {label: bench_gather_rows.measure(*ti) for label, ti in gather_inputs.items()}
    main_k1 = gather_timed["main_path_bf16"]
    k1 = {
        "name": "gather_rows", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
        "replaces": "dist_gnn_tpu/ops/gather_pallas.py:111",
        "max_abs_err": max_abs(out, ref), "ms": main_k1["k1"]["ms"],
        "plain_ms": cuda_time_ms(lambda: gather.gather_rows_plain(features, safe)),
        "bound_ms": main_k1["bound_ms"], "bound_by": "bytes", "library_ms": main_k1["index_select"]["ms"],
        "device_ms": main_k1["k1"]["device_ms"],
    }
    emit({"phase": "kernel", "kernel": "K1 gather_rows", "shape": [hg.num_nodes, 100, L],
          "dtype": "bfloat16", "exact": True, "bytes": main_k1["bytes"], "device_ms": main_k1["k1"]["device_ms"],
          "library_is": "torch.index_select",
          "shapes": {label: {"bound_ms": r["bound_ms"], "k1": r["k1"], "index_select": r["index_select"]}
                     for label, r in gather_timed.items()}, **k1, **card})

    # K3 at the three layers of one request: layer l aggregates over the
    # block that reversed(blocks)[l] names, from an h of that block's
    # frontier size (layer 0: the gathered features; deeper: hidden 256).
    # bench_gather_mean gives these inputs (and each backward's d_out) and
    # times each call: event ms, device ms of every op the call launches,
    # host µs per call; at layers 1 and 2 also K3's training form and both
    # backwards as a step runs them.
    k3_inputs = bench_gather_mean.layer_inputs(blocks, out)
    k3_timed = bench_gather_mean.measure(k3_inputs)
    k3_layers = []
    sum_keys = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "host_us_per_call")
    k3_sum = dict.fromkeys(sum_keys, 0.0)
    k3_err = 0.0
    for x, timed in zip(k3_inputs, k3_timed["k3"]):
        l, h, slots, m = x["layer"], x["h"], x["slots"], x["mask"]
        got = gather.gather_mean(h, slots, m)
        want = spmm.gather_mean(h, slots, m)
        err = rel_err(got, want)
        check(err <= K3_BF16_TOL, f"K3 bf16 layer {l}: error {err} > {K3_BF16_TOL}")
        err32 = rel_err(gather.gather_mean(h.float(), slots, m), spmm.gather_mean(h.float(), slots, m))
        check(err32 <= K3_F32_TOL, f"K3 f32 layer {l}: error {err32} > {K3_F32_TOL}")
        k3_err = max(k3_err, max_abs(got, want))
        table = torch.cat([h, torch.zeros(1, h.shape[1], device=cuda, dtype=h.dtype)])
        bag = torch.where(m, slots, h.shape[0]).long()
        lay = {
            **timed, "rel_err_bf16": err, "rel_err_f32": err32,
            "plain_ms": cuda_time_ms(lambda: spmm.gather_mean(h, slots, m)),
            "library_ms": cuda_time_ms(lambda: F.embedding_bag(
                bag, table, mode="mean", padding_idx=h.shape[0])),
        }
        lay["library_max_abs_err"] = max_abs(
            F.embedding_bag(bag, table, mode="mean", padding_idx=h.shape[0]), got)
        for key in k3_sum:
            k3_sum[key] += lay[key] or 0.0
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

    # K2 at the same four shapes (measured with K1 above), with its plain
    # version's time and rows_per_step 32 beside them
    k2_shapes = {}
    for label, (table, idx) in gather_inputs.items():
        got = gather.gather_rows_dma(table, idx)
        check(torch.equal(got, gather.gather_rows_dma_plain(table, idx)), f"K2 differs from table[idx] at {label}")
        r = gather_timed[label]
        k2_shapes[label] = {
            **{key: r[key] for key in ("N", "F", "L", "dtype", "unique_rows", "bytes", "bound_ms")},
            "rows_per_step": 128, "vec_bytes": gather._vec_bytes(r["F"] * table.element_size(), table, got),
            "ms": r["k2"]["ms"], "device_ms": r["k2"]["device_ms"],
            "ms_rows_per_step_32": cuda_time_ms(lambda: gather.gather_rows_dma(table, idx, rows_per_step=32)),
            "plain_ms": cuda_time_ms(lambda: gather.gather_rows_dma_plain(table, idx)),
            "library_ms": r["index_select"]["ms"], "k1_ms": r["k1"]["ms"], "k1_device_ms": r["k1"]["device_ms"],
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
    del bench_bf16, bench_idx, gather_inputs
    prim = k2_shapes["bench_bf16"]
    k2 = {"name": "gather_rows_dma", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
          "replaces": "dist_gnn_tpu/ops/gather_pallas.py:211", "max_abs_err": 0.0,
          **{key: prim[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms")},
          "bound_by": "bytes"}
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
    reset_counts()
    t0 = time.perf_counter()
    answers = [trainer.eval_step(None, graph, features, labels, *r) for r in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    want = {**dict.fromkeys(counters, 0), "sample_uniform": 3 * N_REQUESTS, "gather_rows": N_REQUESTS,
            "gather_mean": 3 * N_REQUESTS}
    check(launches == want, f"serving launches {launches}, expected 3 K6, 1 K1 and 3 K3 per request")
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
        check(bool(kernels), "serving: the profiler recorded no device activity")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
        return {"stage_ms_per_request": {k: v / N_REQUESTS * 1e3 for k, v in stage_s.items()},
                "profiled_ms_per_request": prof_wall / prof_reqs,
                "device_busy_share": sum(ms for ms, _ in kernels.values()) / prof_wall,
                "device_kernels_per_request": sum(n for _, n in kernels.values()) / prof_reqs,
                "top_kernels_ms_per_request": [[k[:80], ms / prof_reqs, n / prof_reqs]
                                               for k, (ms, n) in top]}

    emit({"phase": "serving", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / serve_s, "sampled_edges": req_edges,
          "logits_rel_err_vs_plain": logits_err, "correct": correct, "answered": answered,
          "launches": launches, **request_breakdown(model, trainer), **card})
    k1["launches"] = launches["gather_rows"]
    k6["launches"] = launches["sample_uniform"]

    # ---- 6. K3-csr, the full-graph walk -------------------------------------
    # on the 500k graph (untimed, every width, dtype and epilogue), then at
    # the benchmark cell's shapes, timed as a SAGE pass runs it: layer 0 on
    # the bf16 features (F 100), layers 1 and 2 on a bf16 [N, 256]
    from dist_gnn_tpu_torch.scripts import bench_gather_mean_csr as bench_csr
    from gnnbench import graphgen

    csr_gen = torch.Generator(device=cuda).manual_seed(11)
    csr_small = []
    csr_ip, csr_ix = graph.indptr.to(torch.int64), graph.indices
    for h in (features, torch.randn((hg.num_nodes, 256), generator=csr_gen, device=cuda)):
        for dt in (torch.bfloat16, torch.float32):
            for mean in (True, False):
                r = bench_csr.measure(h.to(dt), csr_ip, csr_ix, mean, timed=False)
                tol = K3_BF16_TOL if dt == torch.bfloat16 else K3CSR_F32_TOL
                check(r["rel_err"] <= tol and r["bit_identical"], f"K3-csr at 500k nodes: {r}")
                csr_small.append({k: r[k] for k in ("F", "dtype", "mean", "rel_err", "bit_identical")})
    csr_plan_np = np.diff(arrays["indptr"])
    plan = gather.csr_plan(csr_ip, csr_ix.numel())
    check(sorted(plan.rows[: int(plan.n_heavy)].tolist()) == np.nonzero(csr_plan_np > gather.CSR_LIGHT_MAX)[0].tolist()
          and int(plan.heavy_edges) == int(csr_plan_np[csr_plan_np > gather.CSR_LIGHT_MAX].sum()),
          "K3-csr's plan differs from the degrees")
    del plan, csr_ip
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "gnnbench", "configs",
                           "sage-products.json")) as f:
        cell_cfg = json.load(f)
    cell = graphgen.make_graph(cell_cfg, cell_cfg["graph"]["graph_seed"], cuda)
    cell_ip, cell_ix = cell["indptr"].to(torch.int64), cell["indices"]
    csr_layers = [bench_csr.measure(cell["features"], cell_ip, cell_ix, True)]
    hidden = torch.randn((cell_ip.numel() - 1, 256), generator=csr_gen, device=cuda).to(torch.bfloat16)
    csr_layers.append(bench_csr.measure(hidden, cell_ip, cell_ix, True))
    csr_layers.append(bench_csr.measure(hidden, cell_ip, cell_ix, False, timed=False))
    for r in csr_layers:
        check(r["rel_err"] <= K3_BF16_TOL and r["bit_identical"], f"K3-csr at the cell's shapes: {r}")
    del cell, cell_ip, cell_ix, hidden
    torch.cuda.empty_cache()
    pass_layers = [csr_layers[0], csr_layers[1], csr_layers[1]]  # a SAGE pass: F 100, then 256 twice
    k3c = {"name": "gather_mean_csr", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
           "replaces": "none: XLA band matmuls in dist_gnn_tpu/models/inference.py; the port's K1 + index_add_ walk",
           "max_abs_err": max(r["rel_err"] for r in csr_layers), "bound_by": "bytes",
           **{key: sum(r[key] for r in pass_layers) for key in ("ms", "device_ms", "bound_ms", "plain_ms",
                                                                "library_ms")}}
    emit({"phase": "kernel", "kernel": "K3-csr gather_mean_csr", "times_are": "sums over a SAGE pass's three "
          "layers at the benchmark's shapes (2.45M nodes, 123.7M edges; F 100, 256, 256, bf16)",
          "light_max": gather.CSR_LIGHT_MAX, "cell_layers": csr_layers, "small_graph": csr_small, **k3c, **card})

    # ---- 6b. full-graph inference ----------------------------------------
    small, _ = make_synthetic_dataset(
        num_nodes=20_000, avg_degree=30, feature_dim=100, num_classes=47, train_frac=0.2, seed=1,
    )
    shg = HostGraph(indptr=small["indptr"], indices=small["indices"])
    sfeat = torch.from_numpy(small["features"]).to(torch.bfloat16)

    def full_graph_phase(name, m):
        """``full_graph_inference`` of ``m`` over the 500k-node graph, timed
        warm with its launches counted (GAT: K1 and nothing else; SAGE and
        GCN: the plan once and K3-csr once a layer), then held against the
        same function on the CPU on the 20k-node graph."""
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
        if isinstance(m, GAT):
            ok = full_launches["gather_rows"] > 0 and sum(full_launches.values()) == full_launches["gather_rows"]
        else:  # the plan once, K3-csr once a layer, nothing else
            want = {"csr_plan": 1, "gather_mean_csr": len(FAN_OUT)}
            ok = {k: v for k, v in full_launches.items() if v} == want
        check(ok, f"{name}: launches {full_launches}")
        del out_full
        full_kernels, full_prof_ms = profile_device(
            lambda: full_graph_inference(m, None, hg, features, device=cuda), iters=1)
        check(bool(full_kernels), f"{name}: the profiler recorded no device activity")
        full_top = sorted(full_kernels.items(), key=lambda kv: -kv[1][0])[:6]
        got = full_graph_inference(m, None, shg, sfeat, device=cuda)
        want = full_graph_inference(copy.deepcopy(m).to("cpu"), None, shg, sfeat, device="cpu")
        small_err = rel_err(got.cpu(), want)
        check(small_err <= LOGITS_BF16_TOL, f"{name}: CUDA vs CPU at 20k nodes: {small_err}")
        emit({"phase": name, "num_nodes": hg.num_nodes, "num_edges": hg.num_edges,
              "seconds": full_s, "edges_per_s": len(FAN_OUT) * hg.num_edges / full_s,
              "launches": full_launches, "profiled_s": full_prof_ms / 1e3,
              "device_busy_share": sum(ms for ms, _ in full_kernels.values()) / full_prof_ms,
              "top_kernels_ms": [[k[:80], ms, n] for k, (ms, n) in full_top],
              "check_nodes": shg.num_nodes,
              "check_rel_err_vs_cpu": small_err, **card})
        return full_launches

    k3c["launches"] = full_graph_phase("full_graph_inference", model)["gather_mean_csr"]

    # ---- 7. K3 backward, K4 and K5 against their plain versions ---------
    def call_device_ms(fn, names, iters=10):
        """Device ms per call of ``fn`` in the kernels whose names contain
        one of ``names``, from the profiler; fails if it recorded none."""
        kernels, _ = profile_device(fn, iters=iters)
        hits = [ms for k, (ms, _) in kernels.items() if any(n in k for n in names)]
        check(bool(hits), f"the profiler recorded none of {names}")
        return sum(hits) / iters

    kgen = torch.Generator(device=cuda).manual_seed(3)
    sage_blocks = list(reversed(blocks))  # input-first, as the model sees them

    def same_transpose(tr, tp, cap, n_slots, where):
        """The slot transpose on the card against its plain version: equal
        offsets, and each list the same set of flat slots (the card's order
        within a list is its atomics').  Returns the largest difference."""
        offsets = tp.offsets.cpu().long()
        n = int(offsets[-1])
        rows = torch.repeat_interleave(torch.arange(cap), offsets[1:] - offsets[:-1])
        key = rows * (n_slots + 1)
        lists = torch.sort(key + tr.entries[:n].cpu().long())[0] - (key + tp.entries[:n].cpu().long())
        diff = float((tr.offsets.cpu().long() - offsets).abs().max())
        if n:
            diff = max(diff, float(lists.abs().max()))
        check(diff == 0, f"slot transpose differs from its plain version at {where} by {diff}")
        return diff

    def bwd_checks(h, d_out, slots, m, where):
        """K3's training form and its backward against their plain versions
        in bf16 and f32.  The training form (h needs a gradient) is what a
        step runs: its output must equal K3's without a gradient, and the
        transpose the same call builds must equal slot_transpose_plain, as
        the standalone slot_transpose's must.  Autograd's gradient through it
        must agree with gather_mean_bwd_plain, equal the standalone
        gather_mean_bwd's bit for bit, equal itself over two steps (the
        sum's order is fixed) and, in f32, be compared to the gather form's
        plain version on the CPU, which sums in the same order.  Returns
        the bf16 gradient, its plain version, the errors and the
        transposes' largest difference."""
        cap, n_slots = h.shape[0], slots.numel()
        tp = gather.slot_transpose_plain(slots, m, cap)
        t_diff = same_transpose(gather.slot_transpose(slots, m, cap), tp, cap, n_slots, f"{where}, alone")
        res = {}
        for dt, k3_tol, tol in ((torch.bfloat16, K3_BF16_TOL, BWD_BF16_TOL),
                                (torch.float32, K3_F32_TOL, BWD_F32_TOL)):
            hq, dq = h.to(dt).detach().requires_grad_(True), d_out.to(dt)
            grads = []
            for _ in range(2):
                y = gather.gather_mean(hq, slots, m)
                built = gather._transpose_view(y.grad_fn.ws, cap, n_slots)
                t_diff = max(t_diff, same_transpose(built, tp, cap, n_slots, f"{where}, training form"))
                grads.append(torch.autograd.grad(y, hq, dq)[0])
            y = y.detach()
            check(torch.equal(y, gather.gather_mean(hq.detach(), slots, m)),
                  f"K3 {where} {dt}: the training form's output differs from K3's")
            e_k3 = rel_err(y, spmm.gather_mean(hq.detach(), slots, m))
            check(e_k3 <= k3_tol, f"K3 training form {where} {dt}: error {e_k3} > {k3_tol}")
            want = gather.gather_mean_bwd_plain(dq, slots, m, cap)
            err = share_err(grads[0], want)
            check(err <= tol, f"K3-bwd {where} {dt}: error {err} > {tol}")
            check(torch.equal(grads[0], grads[1]), f"K3-bwd {where} {dt}: two steps differ")
            check(torch.equal(grads[0], gather.gather_mean_bwd(dq, slots, m, cap)),
                  f"K3-bwd {where} {dt}: a step's gradient differs from gather_mean_bwd's")
            res[dt] = (grads[0], want, err)
        got, want, err = res[torch.bfloat16]
        g32, _, err32 = res[torch.float32]
        csr = gather.gather_mean_bwd_csr_plain(d_out.float().cpu(), m.cpu(),
                                               gather.SlotTranspose(*(t.cpu() for t in tp)), cap)
        named = torch.zeros(cap, dtype=torch.bool, device=cuda)
        named[slots[m].long()] = True
        check(bool((got[~named] == 0).all()), f"K3-bwd {where}: rows no slot names must be 0")
        return got, want, t_diff, {"err_bf16": err, "err_f32": err32,
                                   "f32_equal_to_csr_plain_on_cpu": torch.equal(g32.cpu(), csr),
                                   "f32_max_abs_vs_csr_plain_on_cpu": max_abs(g32.cpu(), csr)}

    # K3's training form and backward where a SAGE step runs them: layers 1
    # and 2 (layer 0's input, the gathered features, needs no gradient).
    # "ms" times the backward as a function, the transpose built in the
    # call; "as_a_step" times the backward of a training-form output's
    # autograd node, whose forward built the transpose.  The slot transpose
    # is timed on its own as well.
    k3b_layers, st_layers, k3b_err, st_diff = [], [], 0.0, 0.0
    k3b_sum = dict.fromkeys(sum_keys, 0.0)
    st_sum = dict.fromkeys(("ms", "plain_ms", "bound_ms", "device_ms", "host_us_per_call", "queued_ms"), 0.0)
    for x, timed in zip(k3_inputs[1:], k3_timed["k3_bwd"]):
        l, h, slots, m, d_out = x["layer"], x["h"], x["slots"], x["mask"], x["d_out"]
        S, kk = slots.shape
        cap = h.shape[0]
        got, want, t_diff, errs = bwd_checks(h, d_out, slots, m, f"layer {l}")
        k3b_err, st_diff = max(k3b_err, max_abs(got, want)), max(st_diff, t_diff)
        table = torch.zeros(cap + 1, d_out.shape[1], device=cuda, dtype=torch.bfloat16, requires_grad=True)
        bag = torch.where(m, slots, cap).long()
        bag_out = F.embedding_bag(bag, table, mode="mean", padding_idx=cap)
        lay = {
            **timed, **errs,
            "plain_ms": cuda_time_ms(lambda: gather.gather_mean_bwd_plain(d_out, slots, m, cap)),
            "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
                bag_out, table, d_out, retain_graph=True)),
        }
        # slots and mask read; offsets, entries, their divisors and each row's divisor written
        st_bytes = bench_k6.transpose_bytes(slots, m, cap)
        st = {"layer": l, "S": S, "k": kk, "cap": cap, "bytes": st_bytes,
              **bench_gather_mean.time_call(lambda: gather.slot_transpose(slots, m, cap)),
              "queued_ms": bench_k6.queued_ms(lambda: gather.slot_transpose(slots, m, cap)),
              "plain_ms": cuda_time_ms(lambda: gather.slot_transpose_plain(slots, m, cap)),
              "bound_ms": st_bytes / HBM_BYTES_PER_S * 1e3}
        check(round(st["device_ops_per_call"]) == 4 and not any("Memset" in op for op in st["device_ms_by_op"]),
              f"slot transpose layer {l}: {st['device_ms_by_op']} is not four kernels and no memset")
        # built twice on one input: equal offsets and lists
        tp = gather.slot_transpose_plain(slots, m, cap)
        for _ in range(2):
            st_diff = max(st_diff, same_transpose(gather.slot_transpose(slots, m, cap), tp, cap, S * kk,
                                                  f"layer {l}, built again"))
        for acc, row in ((k3b_sum, lay), (st_sum, st)):
            for key in acc:
                acc[key] += row[key] or 0.0
        k3b_layers.append(lay)
        st_layers.append(st)
    # an odd width, all-masked rows, source rows no slot names, and a row
    # named by 45 slots (a list longer than a warp)
    odd_src = torch.randn(300, 37, device=cuda, generator=kgen).to(torch.bfloat16)
    odd_d = torch.randn(50, 37, device=cuda, generator=kgen).to(torch.bfloat16)
    odd_s = torch.randint(0, 300, (50, 7), device=cuda, dtype=torch.int32, generator=kgen)
    odd_s[:, 0] = 5
    odd_m = torch.rand(50, 7, device=cuda, generator=kgen) < 0.6
    odd_m[:2] = False
    odd_m[5:, 0] = True
    _, _, t_diff, odd_errs = bwd_checks(odd_src, odd_d, odd_s, odd_m, "odd F")
    st_diff = max(st_diff, t_diff)
    # a slot table above the 2^20 keys of one bitmap window: 70,000 rows x
    # 16 slots naming 200,000 source rows with a power law (slot =
    # cap * u^3), so the first rows are hubs named thousands of times
    big_S, big_k, big_cap, big_F = 70_000, 16, 200_000, 64
    u = torch.rand(big_S, big_k, device=cuda, generator=kgen)
    big_s = torch.clamp((big_cap * u ** 3).long(), 0, big_cap - 1).to(torch.int32)
    big_m = torch.rand(big_S, big_k, device=cuda, generator=kgen) < 0.9
    big_named = torch.bincount(big_s[big_m].long(), minlength=big_cap)
    check(big_S * big_k > 2**20 and int((big_named > 32).sum()) > 0,
          "the large K3-bwd case needs more than 2^20 slots and hub rows")
    big_h = torch.randn(big_cap, big_F, device=cuda, generator=kgen)
    big_d = torch.randn(big_S, big_F, device=cuda, generator=kgen)
    _, _, t_diff, big_errs = bwd_checks(big_h, big_d, big_s, big_m, "S*k above 2^20")
    st_diff = max(st_diff, t_diff)
    big_errs.update({"S": big_S, "k": big_k, "cap": big_cap, "F": big_F, "slots": big_S * big_k,
                     "hub_rows": int((big_named > 32).sum()), "most_named": int(big_named.max())})
    del u, big_s, big_m, big_named, big_h, big_d
    # a 2^21-slot table over 400,000 rows, one of which more than 10,000
    # valid slots name (bench_k6's tr_hub case), against the plain version;
    # then one capture of layer 1's transpose, replayed on a new slot table
    # copied into its buffers
    hub_s, hub_m, hub_named = bench_k6.hub_table(cuda)
    st_diff = max(st_diff, same_transpose(gather.slot_transpose(hub_s, hub_m, bench_k6.HUB_CAP),
                                          gather.slot_transpose_plain(hub_s, hub_m, bench_k6.HUB_CAP),
                                          bench_k6.HUB_CAP, hub_s.numel(), "the 2^21-slot hub table"))
    st_hub = {"S": hub_s.shape[0], "k": hub_s.shape[1], "cap": bench_k6.HUB_CAP, "hub_named": hub_named,
              **bench_gather_mean.time_call(lambda: gather.slot_transpose(hub_s, hub_m, bench_k6.HUB_CAP))}
    del hub_s, hub_m
    x1 = k3_inputs[1]
    sl_buf, mk_buf, cap1 = x1["slots"].clone(), x1["mask"].clone(), x1["h"].shape[0]
    gather.slot_transpose(sl_buf, mk_buf, cap1)
    torch.cuda.synchronize()
    st_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(st_graph):
        st_captured = gather.slot_transpose(sl_buf, mk_buf, cap1)
    rgen5 = torch.Generator(device=cuda).manual_seed(5)
    sl_buf.copy_(torch.randint(0, cap1, sl_buf.shape, dtype=torch.int32, device=cuda, generator=rgen5))
    mk_buf.copy_(torch.rand(mk_buf.shape, device=cuda, generator=rgen5) < 0.7)
    st_graph.replay()
    torch.cuda.synchronize()
    st_diff = max(st_diff, same_transpose(st_captured, gather.slot_transpose_plain(sl_buf, mk_buf, cap1), cap1,
                                          sl_buf.numel(), "layer 1, replayed from a CUDA graph"))
    del st_graph, st_captured, sl_buf, mk_buf
    k3b = {
        "name": "gather_mean_bwd", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
        "replaces": "dist_gnn_tpu/ops/gather_pallas.py:279", "max_abs_err": k3b_err,
        **k3b_sum, "bound_by": "bytes",
    }
    st_k = {"name": "slot_transpose", "route": "cuda", "source": "dist_gnn_tpu_torch/csrc/gather.cu",
            "replaces": "none: a helper of the K3 backward, with no TPU counterpart",
            "max_abs_err": st_diff, **st_sum, "bound_by": "bytes", "library_ms": None}
    emit({"phase": "kernel", "kernel": "K3-bwd gather_mean_bwd", "dtype": "bfloat16",
          "replaces_note": "the backward of K3; the JAX package differentiates its jnp mean "
                           "through XLA and has no Pallas backward",
          "times_are": "sums over SAGE layers 1 and 2 of one step, each call building its transpose",
          "layers": k3b_layers, "odd_width": odd_errs, "above_2_20_slots": big_errs,
          "per_step_k3": k3_timed["per_step"],
          "library_is": "backward of F.embedding_bag(mode='mean')", **k3b, **card})
    emit({"phase": "kernel", "kernel": "slot_transpose", "exact": True,
          "times_are": "sums over SAGE layers 1 and 2 of one step", "layers": st_layers,
          "hub_table": st_hub, "ops_per_build": 4, "memsets_per_build": 0, "cuda_graph_replay_equal": True,
          "library": "none: no one PyTorch call builds the CSR transpose", **st_k, **card})

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
    k4_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0}
    k5_sum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0}
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
                check(lay[key] is not None, f"layer {l}: no {key} for K4/K5")
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
    k9, k9b = attention_phase(cuda, kgen, sage_blocks, call_device_ms, cuda_time_ms, card)
    k10 = dropout_phase(cuda, kgen, sage_blocks, call_device_ms, cuda_time_ms, card)

    # ---- 8. training: gradients against the plain path, then 8 steps -----
    @contextlib.contextmanager
    def plain_kernels():
        """Every kernel on the training path swapped for its plain version,
        on the same CUDA tensors (a check of the kernels, not a mode of the
        port)."""
        swaps = [(sage_mod, "gather_mean", spmm.gather_mean),
                 (sage_mod, "dropout", drop_ops.dropout_plain),
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

    trainer_ms_per_step = {}  # each train_phase's ms per Trainer.train_step, beside the apps' own

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
        check(bool(kern), f"{name}: the profiler recorded no device activity")
        kept_share = profile_device.kept_share
        busy = sum(ms for ms, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
        trainer_ms_per_step[name] = step_s * 1e3
        emit({"phase": name, "steps": N_STEPS, "batch": BATCH, "ms_per_step": step_s * 1e3,
              "trained_edges_per_s": edges / step_s, "valid_edges_per_step": edges,
              "losses": losses, "launches": launches,
              "launches_per_step": {k: v / N_STEPS for k, v in launches.items()}, **checked,
              "stage_ms_per_step": {k: v / N_STEPS * 1e3 for k, v in stage.items()},
              "profiled_ms_per_step": prof_wall / prof_steps,
              "device_busy_share": busy / prof_wall, "profiler_kept_share": kept_share,
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
        {**dict.fromkeys(counters, 0), "sample_uniform": 3, "gather_rows": 1, "gather_mean": 3,
         "slot_transpose": 2, "gather_mean_bwd": 2, "dropout": DROPOUT_PER_STEP}, 20,
        lambda *a: kernel_grad_check("training_sage", sage_train, sage32, *a))

    # K1 or K2 for the trainer's gather, inside SAGE steps, in bf16 and f32:
    # one timed batch and one profiled step each (bench_gather_rows' main
    # runs the study over 8 batches)
    in_step = {"bf16": bench_gather_rows.in_step(sage_train, graph, features, labels, train_batches[:2], 60, 1),
               "f32": bench_gather_rows.in_step(sage32, graph, features32, labels, train_batches[:2], 61, 1)}
    emit({"phase": "k1_or_k2_in_step", "rows": BATCH, "in_step": in_step,
          "trainer_gather": "K2" if all(r["k2_faster"] for r in in_step.values()) else "K1", **card})

    # K3 three times per step, at layers 1 and 2 with the transpose the
    # backward reads
    k3["launches"] = sage_launches["gather_mean"]
    st_k["launches"] = sage_launches["slot_transpose"]
    k3b["launches"] = sage_launches["gather_mean_bwd"]
    k10["launches"] = sage_launches["dropout"]
    gat_model = GAT(100, 128, meta["num_classes"], len(FAN_OUT), num_heads=4,
                    compute_dtype=torch.bfloat16, generator=torch.Generator().manual_seed(5),
                    device=cuda)
    gat32 = GAT(100, 128, meta["num_classes"], len(FAN_OUT), num_heads=4, device=cuda)
    gat32.load_state_dict(gat_model.state_dict())
    gat_trainer, gat_launches = train_phase(
        "training_gat", gat_model,
        {**dict.fromkeys(counters, 0), "sample_uniform": 3, "gather_rows": 1, "gat_fwd": 3, "gat_bwd": 3,
         "dropout": DROPOUT_PER_STEP}, 30,
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
    want = {**dict.fromkeys(counters, 0), "sample_uniform": 3 * N_REQUESTS, "gather_rows": N_REQUESTS,
            "gat_fwd": 3 * N_REQUESTS}
    check(g_launches == want, f"GAT serving launches {g_launches}, expected {want}")
    check(sum(int(n) for _, n in g_answers) == N_REQUESTS * BATCH, "every seed answered (GAT)")
    emit({"phase": "serving_gat", "requests": N_REQUESTS, "batch": BATCH,
          "ms_per_request": g_serve_s / N_REQUESTS * 1e3,
          "sampled_edges_per_s": req_edges / g_serve_s, "launches": g_launches,
          "logits_rel_err_vs_plain": g_err,
          "correct": sum(int(c) for c, _ in g_answers), **card})

    # ---- 10. GCN: training and serving ------------------------------------
    gcn_counts = {**dict.fromkeys(counters, 0), "sample_uniform": 3, "gather_rows": 1}
    gcn_model = GCN(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(8), device=cuda)
    gcn32 = GCN(100, 256, meta["num_classes"], len(FAN_OUT), device=cuda)
    gcn32.load_state_dict(gcn_model.state_dict())
    gcn_trainer, _ = train_phase("training_gcn", gcn_model, {**gcn_counts, "dropout": DROPOUT_PER_STEP}, 40,
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
    want = {k: v * N_REQUESTS for k, v in gcn_counts.items()}
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

    # ---- 13b. weighted SAGE training and serving ----------------------------
    # SAGE at the bench config on the weighted graph with alias tables (K8
    # per hop), under the frontier caps of the port's tuner
    t0 = time.perf_counter()
    caps = tune_sampler_for(hg, arrays["train_idx"], BATCH, FAN_OUT).frontier_caps
    tune_s = time.perf_counter() - t0
    def bench_sage(seed):
        return SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(seed), device=cuda)

    wsage = bench_sage(21)
    wtr = Trainer(model=wsage, fan_out=FAN_OUT, dedup_last=False, frontier_caps=caps, device=cuda)
    wgen_t = torch.Generator(device=cuda).manual_seed(22)
    wtr.train_step(graph_w, features, labels, *train_batches[0], wgen_t)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    wmets = [wtr.train_step(graph_w, features, labels, s, mk, wgen_t) for s, mk in train_batches[1:]]
    torch.cuda.synchronize()
    wstep_s = (time.perf_counter() - t0) / N_STEPS
    wlaunch = read_counts()
    want = {**dict.fromkeys(counters, 0), "sample_biased_alias": 3, "gather_rows": 1, "gather_mean": 3,
            "slot_transpose": 2, "gather_mean_bwd": 2, "dropout": DROPOUT_PER_STEP}
    check(wlaunch == {k: v * N_STEPS for k, v in want.items()}, f"training_sage_biased launches {wlaunch}")
    k8["launches"] = wlaunch["sample_biased_alias"]
    wlosses = [float(m_["loss"]) for m_ in wmets]
    check(all(np.isfinite(wlosses)), "training_sage_biased: loss not finite")
    egen = torch.Generator(device=cuda).manual_seed(23)
    wedges = sum(int(b.neigh_mask.sum()) for s, mk in train_batches[1:]
                 for b in sample_blocks(graph_w, s, mk, FAN_OUT, False, egen, frontier_caps=caps,
                                        dedup_last=False)[0]) / N_STEPS
    wkern, wprof = profile_device(lambda: wtr.train_step(graph_w, features, labels, *train_batches[1], wgen_t),
                                  iters=3)
    check(bool(wkern), "training_sage_biased: the profiler recorded no device activity")
    wkept = profile_device.kept_share
    wtop = sorted(wkern.items(), key=lambda kv: -kv[1][0])[:10]
    # the weighted step beside the uniform one, each under the padded and
    # the tuned caps: rounds of 8 steps in turns (median ms per step), then
    # one profiled call of 3 steps each (device ms and kernels per step)
    cmp_cfgs = {"uniform_padded": (graph, None), "uniform_tuned": (graph, caps),
                "weighted_padded": (graph_w, None), "weighted_tuned": (graph_w, caps)}
    cmp_tr = {name: Trainer(model=bench_sage(30 + j), fan_out=FAN_OUT, dedup_last=False, frontier_caps=c,
                            device=cuda) for j, (name, (_, c)) in enumerate(cmp_cfgs.items())}
    cmp_gen = torch.Generator(device=cuda).manual_seed(27)
    cmp_ms = {name: [] for name in cmp_cfgs}
    for rnd in range(6):
        for name, (g_, _) in cmp_cfgs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s, mk in train_batches[1:]:
                cmp_tr[name].train_step(g_, features, labels, s, mk, cmp_gen)
            torch.cuda.synchronize()
            if rnd:  # the first round warms up
                cmp_ms[name].append((time.perf_counter() - t0) / N_STEPS * 1e3)
    step_compare = {}
    for name, (g_, _) in cmp_cfgs.items():
        ck, cwall = profile_device(
            lambda tr_=cmp_tr[name], g_=g_: tr_.train_step(g_, features, labels, *train_batches[1], cmp_gen), iters=3)
        check(bool(ck), f"step_compare {name}: the profiler recorded no device activity")
        step_compare[name] = {"ms_per_step_median": float(np.median(cmp_ms[name])), "ms_per_step_rounds": cmp_ms[name],
                              "profiled_ms_per_step": cwall / 3,
                              "device_ms_per_step": sum(ms for ms, _ in ck.values()) / 3,
                              "device_kernels_per_step": sum(n for _, n in ck.values()) / 3,
                              "profiler_kept_share": profile_device.kept_share}
    # one serving request: eval_step on 8 batches of validation seeds
    wtr.eval_step(None, graph_w, features, labels, requests[0][0], requests[0][1], wgen_t)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    wans = [wtr.eval_step(None, graph_w, features, labels, s, mk, wgen_t) for s, mk, _ in requests]
    torch.cuda.synchronize()
    wserve_ms = (time.perf_counter() - t0) / N_REQUESTS * 1e3
    wserve_launch = read_counts()
    check(wserve_launch["sample_biased_alias"] == 3 * N_REQUESTS and sum(int(n) for _, n in wans) == N_REQUESTS * BATCH,
          f"weighted serving: {wserve_launch}")
    # 2 epochs, then the full-graph validation accuracy
    wconv = bench_sage(24)
    wctr = Trainer(model=wconv, fan_out=FAN_OUT, dedup_last=False, frontier_caps=caps, device=cuda)
    wcgen = torch.Generator(device=cuda).manual_seed(25)
    t0 = time.perf_counter()
    n_wc, w_sovf, w_fovf = 0, 0, 0
    for ep in range(CONV_EPOCHS):
        for s, mk in conv_seeds.epoch(torch.Generator(device=cuda).manual_seed(210 + ep)):
            wm = wctr.train_step(graph_w, features, labels, s, mk, wcgen)
            w_sovf = w_sovf + wm["sampler_overflow"]
            w_fovf = w_fovf + wm["frontier_overflow"]
            n_wc += 1
    torch.cuda.synchronize()
    wconv_s = time.perf_counter() - t0
    w_logits = full_graph_inference(wconv, None, hg, features, device=cuda)
    w_val = float((torch.argmax(w_logits, dim=-1)[vid] == labels[vid]).float().mean())
    check(w_val >= VAL_ACC_MIN, f"weighted val_acc {w_val} below {VAL_ACC_MIN}")
    emit({"phase": "training_sage_biased", "frontier_caps": list(caps), "tune_sampler_s": tune_s,
          "padded_caps": layer_capacities(BATCH, FAN_OUT)[1:], "steps": N_STEPS, "batch": BATCH,
          "ms_per_step": wstep_s * 1e3, "trained_edges_per_s": wedges / wstep_s, "valid_edges_per_step": wedges,
          "losses": wlosses, "launches_per_step": {k: v / N_STEPS for k, v in wlaunch.items() if v},
          "sampler_overflow_per_step": [int(m_["sampler_overflow"]) for m_ in wmets],
          "frontier_overflow_per_step": [int(m_["frontier_overflow"]) for m_ in wmets],
          "profiled_ms_per_step": wprof / 3,
          "device_busy_share": sum(ms for ms, _ in wkern.values()) / wprof,
          "device_kernels_per_step": sum(n for _, n in wkern.values()) / 3, "profiler_kept_share": wkept,
          "top_kernels_ms_per_step": [[k[:80], ms / 3, n / 3] for k, (ms, n) in wtop],
          "step_compare": step_compare,
          "serving_ms_per_request": wserve_ms, "serving_launches": {k: v for k, v in wserve_launch.items() if v},
          "epochs": CONV_EPOCHS, "epoch_steps": n_wc, "train_s": wconv_s,
          "epochs_sampler_overflow": int(w_sovf), "epochs_frontier_overflow": int(w_fovf),
          "val_acc": w_val, "val_acc_min": VAL_ACC_MIN, **card})

    # ---- 14. the host-resident tiers -----------------------------------------
    # features (and structure) in host memory, hot rows on the card, misses
    # staged per batch through pinned slabs (host_tier.py, HostTierTrainer)
    feats_host = np.ascontiguousarray(arrays["features"], np.float32)  # the base tier, host memory
    labels_np = np.asarray(arrays["labels"], np.int32)
    F_DIM = feats_host.shape[1]
    t0 = time.perf_counter()
    cm = calibrate(feature_dim=F_DIM, device=cuda)
    calibrate_host_staging(feature_dim=F_DIM, batch_rows=1 << 17, cm=cm, device=cuda)  # a stage's size
    emit({"phase": "cost_model", "hbm_gather_GBps": cm.bandwidth_hbm / 1e9,
          "host_gather_GBps": cm.staging_gather_bandwidth / 1e9,
          "h2d_GBps": cm.staging_h2d_bandwidth / 1e9, "host_serial_GBps": cm.bandwidth_host / 1e9,
          "feature_dim": F_DIM, "seconds": time.perf_counter() - t0, **card})

    # the cache plan at the example's --hot-frac default: 20% of the
    # structure plus the f32 features
    struct_bytes = hg.indptr.nbytes + hg.indices.nbytes
    capacity = int(0.2 * (struct_bytes + feats_host.nbytes))
    t0 = time.perf_counter()
    compute_heats(hg, [arrays["train_idx"]], FAN_OUT, device=cuda)
    torch.cuda.synchronize()
    heat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    mode, s_plan, f_plan = build_cache_plan(hg, F_DIM, [arrays["train_idx"]], FAN_OUT, capacity,
                                            policy="auto", cost=cm, device=cuda)
    plan_ms = (time.perf_counter() - t0) * 1e3
    s_hot = s_plan[0][s_plan[0] != INVALID_ID]
    f_hot = f_plan[0][f_plan[0] != INVALID_ID]
    s_sorted, f_sorted = np.sort(s_hot), np.sort(f_hot)
    plan_used = int(structure_space_bytes(hg, s_hot).sum()) + len(f_hot) * F_DIM * 4
    check(0 < plan_used <= capacity, f"cache plan uses {plan_used} of {capacity} bytes")
    # hit rates over one epoch of device-sampled batches: each hop's valid
    # seeds against the structure set, the input frontier against the
    # feature set
    epoch_np = np.random.default_rng(300).permutation(arrays["train_idx"]).astype(np.int32)
    n_epoch = len(epoch_np) // BATCH
    hits = np.zeros(len(FAN_OUT) + 1)
    tot = np.zeros(len(FAN_OUT) + 1)
    pgen = torch.Generator(device=cuda).manual_seed(301)
    for b in range(n_epoch):
        s = torch.from_numpy(epoch_np[b * BATCH:(b + 1) * BATCH]).to(cuda)
        bl, _ = sample_blocks(graph, s, torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False, pgen,
                              dedup_last=False)
        for h, blk in enumerate(bl):
            ids = blk.seeds[blk.seed_mask].cpu().numpy()
            hits[h] += np_in_sorted(s_sorted, ids)[0].sum()
            tot[h] += len(ids)
        ids = bl[-1].frontier[bl[-1].frontier_mask].cpu().numpy()
        hits[-1] += np_in_sorted(f_sorted, ids)[0].sum()
        tot[-1] += len(ids)
    emit({"phase": "cache_plan", "mode": mode, "capacity_bytes": capacity, "used_bytes": plan_used,
          "hot_structure_nodes": len(s_hot), "hot_feature_nodes": len(f_hot),
          "heat_pass_ms": heat_ms, "build_cache_plan_ms": plan_ms, "epoch_batches": n_epoch,
          "structure_hit_rate_per_hop": (hits[:-1] / tot[:-1]).tolist(),
          "feature_hit_rate_input_frontier": hits[-1] / tot[-1], **card})

    host_batches = [(epoch_np[b * BATCH:(b + 1) * BATCH], np.ones(BATCH, bool)) for b in range(14)]
    N_WARM, N_TIMED = 2, 12

    def fresh_sage(seed, dtype=torch.bfloat16):
        return SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=dtype,
                    generator=torch.Generator().manual_seed(seed), device=cuda)

    def trained_edges(tr, g, seed, batches):
        """Valid sampled slots of each batch, sampled again with the keys
        ``train_batches(..., seed)`` gave it."""
        rng = np.random.default_rng(seed)
        out = []
        for i, (s, mk) in enumerate(batches):
            bl, *_ = tr.sample(g, s, mk, batch_keys(seed, i, cuda)[0], rng)
            out.append(sum(int(b.neigh_mask.sum()) for b in bl))
        return out

    def host_tier_run(name, tr, g, extra):
        """2 warm-up then 12 timed batches of ``train_batches``; returns
        the phase's measures and the timed run's launch counts."""
        tr.train_batches(g, labels_np, host_batches[:N_WARM], 0)
        torch.cuda.synchronize()
        calls0 = native.gather_rows.calls
        torch.cuda.reset_peak_memory_stats(cuda)
        mem0 = torch.cuda.memory_allocated(cuda)
        reset_counts()
        t0 = time.perf_counter()
        mets = tr.train_batches(g, labels_np, host_batches[N_WARM:], 1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / N_TIMED
        peak_mb = (torch.cuda.max_memory_allocated(cuda) - mem0) / 2**20
        launches = read_counts()
        staged_batches = sum(1 for m in mets if m["feat_miss"] > 0)
        # (d) every stage went through the native library built from the
        # port's own source
        check(native.available() and native.gather_rows.calls - calls0 == staged_batches,
              f"{name}: {native.gather_rows.calls - calls0} native gathers for {staged_batches} staged batches")
        check(str(build.BUILD_DIR) in build._LOADED["host"]._name, "host library not from the port's build")
        losses = [float(m["loss"]) for m in mets]
        check(all(np.isfinite(losses)), f"{name}: loss not finite")
        miss = float(np.mean([m["feat_miss"] for m in mets]))
        gather_ms = float(np.mean([m["stage_gather_ms"] for m in mets]))
        probe_ms = float(np.mean([m["stage_probe_ms"] for m in mets]))
        h2d_ms = float(np.mean([m["stage_h2d_ms"] for m in mets]))
        edges = float(np.mean(trained_edges(tr, g, 1, host_batches[N_WARM:])))
        if "struct_miss" in mets[0]:
            extra = {**extra, "struct_miss_per_batch": float(np.mean([m["struct_miss"] for m in mets])),
                     "struct_overflow": sum(m["struct_overflow"] for m in mets),
                     "struct_plan_ms": float(np.mean([m["struct_plan_ms"] for m in mets])),
                     "struct_presample_ms": float(np.mean([m["struct_presample_ms"] for m in mets]))}
        return {"batches": N_TIMED, "ms_per_batch": dt * 1e3, "trained_edges_per_s": edges / dt,
                "valid_edges_per_batch": edges, "feat_miss_rows_per_batch": miss,
                "feat_overflow": sum(m["feat_overflow"] for m in mets),
                "stage_probe_ms": probe_ms, "stage_gather_ms": gather_ms, "stage_h2d_ms": h2d_ms,
                "copy_span_GBps": miss * F_DIM * 4 / (h2d_ms / 1e3) / 1e9 if h2d_ms > 0 else None,
                "staged_MBps": miss * F_DIM * 4 / dt / 2**20,
                "launches_per_batch": {k: v / N_TIMED for k, v in launches.items() if v},
                "peak_MiB_over_start": peak_mb, "losses": losses, **extra}, launches

    # features host-resident, structure on the card (bench.py:443-497):
    # the half of the nodes with the highest degree hot
    deg_np = np.diff(hg.indptr.astype(np.int64))
    half = np.argpartition(deg_np, -(hg.num_nodes // 2))[-(hg.num_nodes // 2):].astype(np.int32)
    fstore = HostFeatureStore(feats_host, half, miss_budget=1 << 17, device=cuda)
    # (a) the assembled input equals a plain gather of the whole host matrix
    bl0, _ = sample_blocks(graph, torch.from_numpy(host_batches[0][0]).to(cuda),
                           torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                           torch.Generator(device=cuda).manual_seed(302), dedup_last=False)
    f0, fm0 = bl0[-1].frontier, bl0[-1].frontier_mask
    st0 = fstore.stage(f0.cpu().numpy(), fm0.cpu().numpy())
    st0.wait()
    got0 = assemble_features(fstore.hot_tier, f0, fm0, st0.rows, st0.slots)
    f0n, fm0n = f0.cpu().numpy(), fm0.cpu().numpy()
    want0 = torch.from_numpy(np.where(fm0n[:, None], feats_host[np.where(fm0n, f0n, 0)], 0))
    check(torch.equal(got0.cpu(), want0), "(a) assemble_features differs from a plain gather of the host matrix")
    check(st0.count > 0 and st0.count < int(fm0.sum()), "(a) both tiers in use")

    ht = HostTierTrainer(model=fresh_sage(12), fan_out=FAN_OUT, store=fstore, dedup_last=False, device=cuda)
    feats_res, launch_feat = host_tier_run("host_tier_features", ht, graph, {})
    want = {"sample_uniform": 3, "gather_rows": 1, "gather_mean": 3, "slot_transpose": 2, "gather_mean_bwd": 2,
            "dropout": DROPOUT_PER_STEP}
    check(launch_feat == {k: want.get(k, 0) * N_TIMED for k in counters},
          f"host_tier_features launches {launch_feat}")
    # the device-resident step on the same batches and graph, f32 features
    # on the card
    feats_dev = torch.from_numpy(feats_host).to(cuda)
    labels_dev = torch.from_numpy(labels_np).to(cuda)
    dtr = Trainer(model=fresh_sage(12), fan_out=FAN_OUT, dedup_last=False, device=cuda)
    dgen = torch.Generator(device=cuda).manual_seed(303)
    dev_batches = [(torch.from_numpy(s).to(cuda), torch.from_numpy(mk).to(cuda)) for s, mk in host_batches]
    for s, mk in dev_batches[:N_WARM]:
        dtr.train_step(graph, feats_dev, labels_dev, s, mk, dgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s, mk in dev_batches[N_WARM:]:
        dtr.train_step(graph, feats_dev, labels_dev, s, mk, dgen)
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) / N_TIMED * 1e3
    # (c) the pipelined run equals a sequential sample -> stage -> compute
    # loop with the same keys (6 batches, f32 params)
    runs = []
    for pipelined in (True, False):
        tr_c = HostTierTrainer(model=fresh_sage(13), fan_out=FAN_OUT, store=fstore, dedup_last=False, device=cuda)
        if pipelined:
            tr_c.train_batches(graph, labels_np, host_batches[:6], 5)
        else:
            rng_c = np.random.default_rng(5)
            for i, (s, mk) in enumerate(host_batches[:6]):
                sk, dk = batch_keys(5, i, cuda)
                blk_c, _, fr, frm = tr_c.sample(graph, s, mk, sk, rng_c)
                tr_c.compute_step(blk_c, fstore.stage(fr, frm), tr_c.batch_labels(labels_np, s, mk),
                                  torch.from_numpy(mk).to(cuda), dk)
        torch.cuda.synchronize()
        runs.append({k: v.detach().clone() for k, v in tr_c.model.state_dict().items()})
    pipe_err = max(rel_err(runs[0][k], runs[1][k]) for k in runs[0])
    pipe_equal = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    check(pipe_err <= 1e-5, f"(c) pipelined params differ from sequential by {pipe_err}")
    emit({"phase": "host_tier_features", "hot_nodes": len(half), "miss_budget": 1 << 17, **feats_res,
          "device_resident_ms_per_step": dev_ms, "assemble_exact": True,
          "pipelined_vs_sequential_rel_err": pipe_err, "pipelined_bit_equal": pipe_equal, **card})

    # structure and features host-resident (--tier host --host-struct), hot
    # sets from the cache plan
    front_cap = layer_capacities(BATCH, FAN_OUT)[-1]
    gstore = HostCSCStore(hg, s_hot, miss_budget=front_cap, deg_cap=128, device=cuda)
    fstore_full = HostFeatureStore(feats_host, f_hot, miss_budget=front_cap, device=cuda)
    # (b) each hop of sample_staged_hop on the card equals the CPU's, bit
    # for bit, with injected keys and the same hub-row seed
    gstore_cpu = HostCSCStore(hg, s_hot, miss_budget=front_cap, deg_cap=128, device="cpu")
    kgen = torch.Generator().manual_seed(304)
    seeds_h, mask_h = host_batches[0][0], host_batches[0][1]
    hop_rows = []
    for i, kk in enumerate(reversed(FAN_OUT)):
        loc_g, st_g = gstore.plan_hop(seeds_h, mask_h, kk, np.random.default_rng(40 + i))
        loc_c, st_c = gstore_cpu.plan_hop(seeds_h, mask_h, kk, np.random.default_rng(40 + i))
        keys = (prng.random_keys(kgen, (len(seeds_h),)), prng.random_keys(kgen, (st_c.count,)))
        reset_counts()
        nb_g = sample_staged_hop(gstore.hot_graph, torch.from_numpy(loc_g).to(cuda), st_g, kk,
                                 tuple(k.to(cuda) for k in keys))
        torch.cuda.synchronize()
        k6_hop = sampling.sample_uniform.launches
        nb_c = sample_staged_hop(gstore_cpu.hot_graph, torch.from_numpy(loc_c), st_c, kk, keys)
        check(torch.equal(nb_g.ids.cpu(), nb_c.ids) and torch.equal(nb_g.mask.cpu(), nb_c.mask),
              f"(b) sample_staged_hop hop {i}: the card differs from the CPU")
        check(k6_hop == 1 + (st_g.count > 0 and st_g.graph.num_edges > 0), f"(b) hop {i}: {k6_hop} K6 launches")
        hop_rows.append({"hop": i, "seeds": len(seeds_h), "staged_rows": st_c.count,
                         "hub_rows": int(st_c.is_pre.sum()), "staged_edges": st_c.graph.num_edges, "k6": k6_hop})
        rl = unique_and_relabel(torch.from_numpy(seeds_h), nb_c.ids, nb_c.mask)
        seeds_h, mask_h = rl.frontier.numpy(), rl.frontier_mask.numpy()
    hf = HostTierTrainer(model=fresh_sage(14), fan_out=FAN_OUT, store=fstore_full, gstore=gstore,
                         dedup_last=False, device=cuda)
    full_res, launch_full = host_tier_run("host_tier_full", hf, None, {})
    k6_per = launch_full["sample_uniform"] / N_TIMED
    check(len(FAN_OUT) <= k6_per <= 2 * len(FAN_OUT), f"host_tier_full: {k6_per} K6 launches per batch")
    # 2 epochs host-resident, then the full-graph validation accuracy
    conv_host = HostTierTrainer(model=fresh_sage(6), fan_out=FAN_OUT, store=fstore_full, gstore=gstore,
                                dedup_last=False, device=cuda)
    # device memory stays flat across an epoch call: each batch's staged
    # rows are freed once its compute is queued, so the peak over 195
    # batches is the peak over the 12 timed ones
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    mem0 = torch.cuda.memory_allocated(cuda)
    t0 = time.perf_counter()
    n_conv_h = 0
    for ep in range(CONV_EPOCHS):
        order = np.random.default_rng(400 + ep).permutation(arrays["train_idx"]).astype(np.int32)
        ep_batches = [(order[b * BATCH:(b + 1) * BATCH], np.ones(BATCH, bool)) for b in range(len(order) // BATCH)]
        mets_h = conv_host.train_batches(None, labels_np, ep_batches, 500 + ep)
        n_conv_h += len(ep_batches)
    torch.cuda.synchronize()
    conv_h_s = time.perf_counter() - t0
    epoch_peak_mb = (torch.cuda.max_memory_allocated(cuda) - mem0) / 2**20
    epoch_end_mb = (torch.cuda.memory_allocated(cuda) - mem0) / 2**20
    check(epoch_peak_mb <= 1.25 * full_res["peak_MiB_over_start"] + 256 and epoch_end_mb <= 64,
          f"host-resident epochs: device memory peaks {epoch_peak_mb:.0f} MiB over the start "
          f"({full_res['peak_MiB_over_start']:.0f} over 12 batches) and ends {epoch_end_mb:.0f} MiB above it")
    h_logits = full_graph_inference(conv_host.model, None, hg, features, device=cuda)
    h_val = float((torch.argmax(h_logits, dim=-1)[vid] == labels[vid]).float().mean())
    check(h_val >= VAL_ACC_MIN, f"host-resident val_acc {h_val} below {VAL_ACC_MIN}")
    emit({"phase": "host_tier_full", "hot_structure_nodes": len(s_hot), "hot_feature_nodes": len(f_hot),
          "miss_budget": front_cap, "deg_cap": 128, "hops_checked": hop_rows, **full_res,
          "k6_per_batch": k6_per,
          "epochs": CONV_EPOCHS, "steps": n_conv_h, "train_s": conv_h_s, "final_loss": float(mets_h[-1]["loss"]),
          "epochs_peak_MiB_over_start": epoch_peak_mb, "epochs_end_MiB_over_start": epoch_end_mb,
          "val_acc": h_val, "val_acc_min": VAL_ACC_MIN, **card})

    # ---- 14b. the host-resident tiers on the weighted graph ------------------
    # the host-structure-and-features cell on the weighted graph: K8 on the
    # hot rows, K7 on the staged rows, hub rows Gumbel-presampled on the host
    w_capacity = int(0.2 * (hg.indptr.nbytes + hg.indices.nbytes + probs_np.nbytes + feats_host.nbytes))
    t0 = time.perf_counter()
    w_mode, ws_plan, wf_plan = build_cache_plan(hg_w, F_DIM, [arrays["train_idx"]], FAN_OUT, w_capacity,
                                                policy="auto", cost=cm, device=cuda)
    w_plan_ms = (time.perf_counter() - t0) * 1e3
    ws_hot = ws_plan[0][ws_plan[0] != INVALID_ID]
    wf_hot = wf_plan[0][wf_plan[0] != INVALID_ID]
    wgstore = HostCSCStore(hg_w, ws_hot, miss_budget=front_cap, deg_cap=128, device=cuda)
    wfstore = HostFeatureStore(feats_host, wf_hot, miss_budget=front_cap, device=cuda)
    # each hop of sample_staged_hop on the card equals the CPU's (the ulp
    # rule on K7's and K8's Gumbel rows), with injected keys and one hub
    # seed; the plan may cache no weighted structure (weights make a row
    # dearer), so this check takes the 5% of nodes of highest degree as the
    # hot structure, and K8 samples their rows
    top_deg = np.argpartition(deg64, -(hg.num_nodes // 20))[-(hg.num_nodes // 20):].astype(np.int32)
    chk_stores = [HostCSCStore(hg_w, top_deg, miss_budget=front_cap, deg_cap=128, device=dev)
                  for dev in (cuda, "cpu")]
    hot_alias = chk_stores[0].hot_graph.alias_prob is not None
    check(hot_alias, "host_tier_biased: the check's hot structure has no alias tables")
    hkgen = torch.Generator().manual_seed(305)
    seeds_h, mask_h = host_batches[0][0], host_batches[0][1]
    w_hop_rows = []
    for i, kk in enumerate(reversed(FAN_OUT)):
        loc_g, st_g = chk_stores[0].plan_hop(seeds_h, mask_h, kk, np.random.default_rng(50 + i))
        loc_c, st_c = chk_stores[1].plan_hop(seeds_h, mask_h, kk, np.random.default_rng(50 + i))
        L = len(seeds_h)
        hot_key = (alias_key_set(L, kk, False, hkgen) if hot_alias
                   else prng.random_keys(hkgen, (L,)))
        hot_key = tuple(x.cpu() for x in hot_key) if hot_alias else hot_key
        stg_key = prng.random_keys(hkgen, (st_c.count,))
        reset_counts()
        nb_g = sample_staged_hop(chk_stores[0].hot_graph, torch.from_numpy(loc_g).to(cuda), st_g, kk,
                                 (tuple(x.to(cuda) for x in hot_key) if hot_alias else hot_key.to(cuda),
                                  stg_key.to(cuda)))
        torch.cuda.synchronize()
        hop_launch = read_counts()
        nb_c = sample_staged_hop(chk_stores[1].hot_graph, torch.from_numpy(loc_c), st_c, kk, (hot_key, stg_key))
        bad = ((nb_g.ids.cpu() != nb_c.ids) | (nb_g.mask.cpu() != nb_c.mask)).any(1).nonzero().flatten().tolist()
        hot_ip = chk_stores[1].hot_graph.indptr.numpy().astype(np.int64)
        hot_pr = chk_stores[1].hot_graph.probs.numpy()
        st_ip = st_c.graph.indptr.numpy().astype(np.int64)
        st_pr = st_c.graph.probs.numpy()
        staged_pos = {int(p): j for j, p in enumerate(st_c.row_of.tolist())}
        for r in bad:
            if loc_c[r] != INVALID_ID:  # a hot row: K8
                ok = hot_alias and k8_tie(hot_ip, hot_pr, loc_c, hot_key[1], kk)(r)
            else:  # a staged row: K7 over the compact sub-CSC
                j = staged_pos.get(r)
                ok = j is not None and k7_tie(st_ip, st_pr, np.arange(st_c.count), stg_key, kk)(j)
            check(ok, f"host_tier_biased hop {i}: row {r} differs between the card and the CPU")
        check(hop_launch["sample_biased"] == (st_g.count > 0 and st_g.graph.num_edges > 0)
              and hop_launch["sample_biased_alias"] == int(hot_alias),
              f"host_tier_biased hop {i}: launches {hop_launch}")
        k7_staged = {}
        if hop_launch["sample_biased"]:  # K7 alone on the staged rows, as the hop calls it
            st_seeds, st_key_c = torch.arange(st_g.count, dtype=torch.int32, device=cuda), stg_key.to(cuda)
            k7_staged = {"k7_ms": cuda_time_ms(lambda: sampling.sample_biased(st_g.graph, st_seeds, kk, False, st_key_c)),
                         "k7_device_ms": device_ms_per_call(
                             lambda: sampling.sample_biased(st_g.graph, st_seeds, kk, False, st_key_c), "k7_"),
                         "staged_max_degree": st_g.graph.max_degree}
        w_hop_rows.append({"hop": i, "seeds": L, "hot_rows": int((loc_c != INVALID_ID).sum()),
                           "staged_rows": st_c.count, "hub_rows": int(st_c.is_pre.sum()),
                           "staged_edges": st_c.graph.num_edges, "presample_ms": st_c.presample_s * 1e3,
                           "near_tie_rows": len(bad), "k7": hop_launch["sample_biased"],
                           "k8": hop_launch["sample_biased_alias"], **k7_staged})
        rl = unique_and_relabel(torch.from_numpy(seeds_h), nb_c.ids, nb_c.mask)
        seeds_h, mask_h = rl.frontier.numpy(), rl.frontier_mask.numpy()
    del chk_stores
    plan_alias = wgstore.hot_graph.alias_prob is not None
    whf = HostTierTrainer(model=fresh_sage(15), fan_out=FAN_OUT, store=wfstore, gstore=wgstore,
                          dedup_last=False, device=cuda)
    wfull_res, wlaunch_full = host_tier_run("host_tier_biased", whf, None, {})
    k7_per = wlaunch_full["sample_biased"] / N_TIMED
    k8_per = wlaunch_full["sample_biased_alias"] / N_TIMED
    check(k7_per > 0 and wlaunch_full["sample_uniform"] == 0 and (k8_per > 0) == plan_alias,
          f"host_tier_biased launches {wlaunch_full}")
    k7["launches"] = wlaunch_full["sample_biased"]
    emit({"phase": "host_tier_biased", "mode": w_mode, "capacity_bytes": w_capacity, "plan_ms": w_plan_ms,
          "hot_structure_nodes": len(ws_hot), "hot_feature_nodes": len(wf_hot), "hot_alias_tables": plan_alias,
          "check_hot_structure_nodes": len(top_deg),
          "miss_budget": front_cap, "deg_cap": 128, "hops_checked": w_hop_rows, **wfull_res,
          "k7_per_batch": k7_per, "k8_per_batch": k8_per, **card})

    # ---- 16. the distributed package: world 1 on NCCL -----------------------
    # one rank on the card, its collectives through NCCL; a gloo group of the
    # same world carries the CPU reference of each check
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        rdv_port = sock.getsockname()[1]
    mesh = initialize_distributed(f"tcp://localhost:{rdv_port}", 0, 1)
    check(mesh.backend == "nccl" and mesh.device == torch.device("cuda", 0) and mesh.size == 1,
          f"world 1: {mesh.backend} on {mesh.device}")
    cpu_mesh = Mesh(rank=0, size=1, device=torch.device("cpu"), group=dist.new_group([0], backend="gloo"))
    t_dist = time.perf_counter()

    # dist_exchange: the world-1 exchange is a K1 gather; the owner-side
    # sampler's table rides NCCL's all_to_all to itself and samples what
    # sample_neighbors samples on that table; the quantized store and the
    # hot tier equal the CPU's
    fr, frm = blocks[-1].frontier, blocks[-1].frontier_mask
    store_b = dfs.ShardedFeatureStore(features, mesh)
    reset_counts()
    mesh.reset_counts()
    rows_x, uns_x = dfs.exchange_gather(store_b.features, fr, frm, mesh, store_b.shard_size)
    direct_x = torch.where(frm[:, None], gather.gather_rows(features, torch.where(frm, fr, 0)), 0)
    check(torch.equal(rows_x, direct_x) and int(uns_x) == 0, "dist_exchange: world-1 exchange != a K1 gather")
    check(read_counts()["gather_rows"] == 2 and sum(mesh.counts.values()) == 0,
          f"dist_exchange: the world-1 exchange ran {read_counts()} and collectives {mesh.counts}")
    q_opts = dict(hot_ids=f_plan, peer_hot=True, quantize=True)
    store_q = dfs.ShardedFeatureStore(arrays["features"], mesh, **q_opts)
    store_q_cpu = dfs.ShardedFeatureStore(arrays["features"], cpu_mesh, **q_opts)
    rq, uq = store_q.fetch_local(fr, frm)
    rq_cpu, uq_cpu = store_q_cpu.fetch_local(fr.cpu(), frm.cpu())
    deq = store_q.dequantize(rq).cpu()
    safe_fr = torch.where(frm, fr, 0).long().cpu()
    want_q = torch.where(frm.cpu()[:, None], dequantize_unpack(torch.from_numpy(quantize_pack(arrays["features"]))[safe_fr]), 0)
    check(torch.equal(deq, store_q_cpu.dequantize(rq_cpu)) and torch.equal(deq, want_q) and int(uq) == int(uq_cpu) == 0,
          "dist_exchange: quantized rows differ between the card, the CPU and the packed matrix")
    q_hits = int(torch.isin(fr[frm], store_q.hot_sorted).sum())
    del store_q, store_q_cpu, rq, rq_cpu, deq, want_q
    sg = ShardedGraph.build(hg, mesh, hot_ids=s_plan)
    sg_cpu = ShardedGraph.build(hg, cpu_mesh, hot_ids=s_plan)
    dgen = torch.Generator().manual_seed(900)
    x_hops = []
    for i, (blk, kk) in enumerate(zip(blocks, reversed(FAN_OUT))):
        s_hop, m_hop = blk.seeds, blk.seed_mask
        L = s_hop.shape[0]
        budget = dfs.request_budget(L, 1, 4.0)
        owner_keys, hot_keys = prng.random_keys(dgen, (L,)), prng.random_keys(dgen, (L,))
        reset_counts()
        mesh.reset_counts()
        nb, _ = sample_neighbors_sharded(sg, s_hop, m_hop, kk, False, owner_keys.to(cuda), budget)
        torch.cuda.synchronize()
        hop_counts, hop_k6 = dict(mesh.counts), read_counts()["sample_uniform"]
        n_valid = int(m_hop.sum())
        order = torch.nonzero(m_hop).flatten()
        table = torch.full((L,), INVALID_ID, dtype=torch.int32, device=cuda)
        table[:n_valid] = s_hop[order]
        direct = sampling.sample_neighbors(graph, table, kk, False, owner_keys.to(cuda))
        want_ids = torch.full((L, kk), INVALID_ID, dtype=torch.int32, device=cuda)
        want_ids[order] = torch.where(direct.mask, direct.ids, INVALID_ID)[:n_valid]
        want_mask = torch.zeros((L, kk), dtype=torch.bool, device=cuda)
        want_mask[order] = direct.mask[:n_valid]
        check(torch.equal(nb.ids, want_ids) and torch.equal(nb.mask, want_mask),
              f"dist_exchange hop {i}: owner-side samples differ from sample_neighbors on the table")
        check(hop_counts["all_to_all"] == 2 and hop_counts["host_syncs"] == 1 and hop_k6 == 1,
              f"dist_exchange hop {i}: collectives {hop_counts}, K6 {hop_k6}")
        key_pair = (hot_keys, owner_keys)
        nbc, _ = sample_neighbors_cached(sg, s_hop, m_hop, kk, False, tuple(k.to(cuda) for k in key_pair), budget)
        nbc_cpu, _ = sample_neighbors_cached(sg_cpu, s_hop.cpu(), m_hop.cpu(), kk, False, key_pair, budget)
        check(torch.equal(nbc.ids.cpu(), nbc_cpu.ids) and torch.equal(nbc.mask.cpu(), nbc_cpu.mask),
              f"dist_exchange hop {i}: the hot tier's samples differ between the card and the CPU")
        x_hops.append({
            "hop": i, "seeds": n_valid, "k": kk, "budget": budget, "collectives": hop_counts,
            "hot_seeds": int(torch.isin(s_hop[m_hop], sg.hot_sorted).sum()),
            "sharded_ms": cuda_time_ms(lambda: sample_neighbors_sharded(sg, s_hop, m_hop, kk, False,
                                                                        owner_keys.to(cuda), budget), iters=10),
            "cached_ms": cuda_time_ms(lambda: sample_neighbors_cached(sg, s_hop, m_hop, kk, False,
                                                                      tuple(k.to(cuda) for k in key_pair), budget),
                                      iters=10),
            "sample_neighbors_ms": cuda_time_ms(lambda: sampling.sample_neighbors(graph, table, kk, False,
                                                                                  owner_keys.to(cuda)), iters=10)})
    del sg_cpu
    # what one collective costs a step at world 1: event ms per call over
    # 50 calls (host bound), and a pending-count read back
    tiny = torch.zeros(1, dtype=torch.int64, device=cuda)
    table_x = torch.zeros((1, 4096), dtype=torch.int32, device=cuda)
    coll_ms = {"all_reduce_8B": cuda_time_ms(lambda: mesh.all_reduce(tiny), iters=50),
               "all_to_all_16KB": cuda_time_ms(lambda: mesh.all_to_all(table_x), iters=50),
               "sum_to_host": cuda_time_ms(lambda: mesh.sum_to_host(tiny[0]), iters=50),
               "k1_16KB": cuda_time_ms(lambda: gather.gather_rows(table_x.reshape(-1, 1), table_x[0]), iters=50)}
    emit({"phase": "dist_exchange", "world": 1, "backend": mesh.backend, "exchange_equals_k1": True,
          "collective_event_ms_per_call": coll_ms,
          "frontier_ids": int(frm.sum()), "quantized_equal_cpu_and_packed": True, "quantized_hot_hits": q_hits,
          "hot_structure_nodes": int((sg.hot_sorted != INVALID_ID).sum()), "hops": x_hops,
          "owner_side_equals_sample_neighbors": True, "hot_tier_equals_cpu": True, **card})

    # dist_training_sage: DistTrainer (replicated structure, a bf16 store)
    # beside Trainer, at the bench config under the tuned caps
    def dist_sage(seed, dtype=torch.bfloat16, dropout=0.5):
        return SAGE(100, 256, meta["num_classes"], len(FAN_OUT), compute_dtype=dtype, dropout=dropout,
                    generator=torch.Generator().manual_seed(seed), device=cuda)

    dlabels = store_b.shard_of(labels[:, None])
    # f32, dropout 0: one dist step and one Trainer step from the same
    # params on the same seeds and keys
    m_a = dist_sage(40, None, 0.0)
    m_b = copy.deepcopy(m_a)
    store32 = dfs.ShardedFeatureStore(features32, mesh)
    s0, mk0 = train_batches[0]
    ma = DistTrainer(model=m_a, fan_out=FAN_OUT, store=store32, dedup_last=False, frontier_caps=caps).train_step(
        graph, store32.shard_of(labels[:, None]), s0, mk0, torch.Generator(device=cuda).manual_seed(41))
    mb = Trainer(model=m_b, fan_out=FAN_OUT, dedup_last=False, frontier_caps=caps, device=cuda).train_step(
        graph, features32, labels, s0, mk0, torch.Generator(device=cuda).manual_seed(41))
    d_loss_err = abs(float(ma["loss"]) - float(mb["loss"])) / max(1.0, abs(float(mb["loss"])))
    d_grad_err = {n: share_err(pa.grad, pb.grad) for (n, pa), (_, pb) in zip(m_a.named_parameters(),
                                                                           m_b.named_parameters())}
    check(d_loss_err <= LOSS_F32_TOL, f"dist_training_sage: f32 loss {float(ma['loss'])} vs {float(mb['loss'])}")
    check(all(e <= GRAD_F32_TOL for e in d_grad_err.values()), f"dist_training_sage: f32 gradients {d_grad_err}")
    del m_a, m_b, store32
    dtr = DistTrainer(model=dist_sage(42), fan_out=FAN_OUT, store=store_b, dedup_last=False, frontier_caps=caps)
    str1 = Trainer(model=dist_sage(42), fan_out=FAN_OUT, dedup_last=False, frontier_caps=caps, device=cuda)
    gen_d, gen_s = torch.Generator(device=cuda).manual_seed(43), torch.Generator(device=cuda).manual_seed(43)
    dtr.train_step(graph, dlabels, *train_batches[0], gen_d)  # warm-up
    str1.train_step(graph, features, labels, *train_batches[0], gen_s)
    dist_ms, single_ms, dist_mets = [], [], []
    for rnd in range(4):  # 8 dist steps and 8 single-device steps in turns; round 0 warms up
        torch.cuda.synchronize()
        reset_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        mets = [dtr.train_step(graph, dlabels, s, mk, gen_d) for s, mk in train_batches[1:]]
        torch.cuda.synchronize()
        if rnd:
            dist_ms.append((time.perf_counter() - t0) / N_STEPS * 1e3)
        d_launch, d_coll = read_counts(), dict(mesh.counts)
        dist_mets += mets
        t0 = time.perf_counter()
        for s, mk in train_batches[1:]:
            str1.train_step(graph, features, labels, s, mk, gen_s)
        torch.cuda.synchronize()
        if rnd:
            single_ms.append((time.perf_counter() - t0) / N_STEPS * 1e3)
    want = {"sample_uniform": 3, "gather_rows": 2, "gather_mean": 3, "slot_transpose": 2, "gather_mean_bwd": 2,
            "dropout": DROPOUT_PER_STEP}
    check(d_launch == {k: want.get(k, 0) * N_STEPS for k in counters}, f"dist_training_sage launches {d_launch}")
    check(d_coll == {"all_to_all": 0, "all_reduce": 3 * N_STEPS, "all_gather": 0, "p2p": 0, "host_syncs": 0},
          f"dist_training_sage collectives {d_coll}")
    check(all(np.isfinite(float(m_["loss"])) and int(m_["overflow"]) == int(m_["sampler_overflow"]) == 0
              for m_ in dist_mets), "dist_training_sage: loss not finite or an overflow")
    egen = torch.Generator(device=cuda).manual_seed(44)
    d_edges = sum(int(b.neigh_mask.sum()) for s, mk in train_batches[1:]
                  for b in sample_blocks(graph, s, mk, FAN_OUT, False, egen, frontier_caps=caps,
                                         dedup_last=False)[0]) / N_STEPS
    dkern, dprof = profile_device(lambda: dtr.train_step(graph, dlabels, *train_batches[1], gen_d), iters=3)
    check(bool(dkern), "dist_training_sage: the profiler recorded no device activity")
    dkept = profile_device.kept_share
    dtop = sorted(dkern.items(), key=lambda kv: -kv[1][0])[:10]
    # 2 epochs, then sampled validation accuracy through eval_step
    dconv = DistTrainer(model=dist_sage(46), fan_out=FAN_OUT, store=store_b, dedup_last=False, frontier_caps=caps)
    dcgen = torch.Generator(device=cuda).manual_seed(47)
    t0 = time.perf_counter()
    n_dc, dc_ovf = 0, torch.zeros((), dtype=torch.int32, device=cuda)
    for ep in range(CONV_EPOCHS):
        for s, mk in conv_seeds.epoch(torch.Generator(device=cuda).manual_seed(220 + ep)):
            dm = dconv.train_step(graph, dlabels, s, mk, dcgen)
            dc_ovf = dc_ovf + dm["overflow"] + dm["sampler_overflow"]
            n_dc += 1
    torch.cuda.synchronize()
    dconv_s = time.perf_counter() - t0
    n_correct = n_total = 0
    t0 = time.perf_counter()
    for s, mk in SeedGenerator(arrays["valid_idx"], BATCH, device=cuda).epoch():
        c_, t_ = dconv.eval_step(None, graph, dlabels, s, mk, dcgen)
        n_correct, n_total = n_correct + c_, n_total + t_
    d_val = float(n_correct) / float(n_total)
    d_eval_s = time.perf_counter() - t0
    check(int(n_total) == len(arrays["valid_idx"]), "dist eval: every validation seed answered")
    check(d_val >= VAL_ACC_MIN, f"dist val_acc {d_val} below {VAL_ACC_MIN}")
    emit({"phase": "dist_training_sage", "world": 1, "backend": mesh.backend, "frontier_caps": list(caps),
          "steps": N_STEPS, "batch": BATCH, "ms_per_step_rounds": dist_ms,
          "ms_per_step": float(np.median(dist_ms)), "single_device_ms_per_step_rounds": single_ms,
          "single_device_ms_per_step": float(np.median(single_ms)),
          "trained_edges_per_s": d_edges / (float(np.median(dist_ms)) / 1e3), "valid_edges_per_step": d_edges,
          "launches_per_step": {k: v / N_STEPS for k, v in d_launch.items() if v},
          "collectives_per_step": {k: v / N_STEPS for k, v in d_coll.items()},
          "f32_loss_err_vs_trainer": d_loss_err, "f32_grad_share_err_vs_trainer": d_grad_err,
          "profiled_ms_per_step": dprof / 3, "device_busy_share": sum(ms for ms, _ in dkern.values()) / dprof,
          "profiler_kept_share": dkept, "device_kernels_per_step": sum(n for _, n in dkern.values()) / 3,
          "top_kernels_ms_per_step": [[k[:80], ms / 3, n / 3] for k, (ms, n) in dtop],
          "epochs": CONV_EPOCHS, "epoch_steps": n_dc, "train_s": dconv_s, "epochs_overflow": int(dc_ovf),
          "eval_s": d_eval_s, "val_acc_sampled": d_val, "val_acc_min": VAL_ACC_MIN, **card})
    for kern, name in ((k6, "sample_uniform"), (k1, "gather_rows"), (k3, "gather_mean"),
                       (st_k, "slot_transpose"), (k3b, "gather_mean_bwd"), (k3c, "gather_mean_csr"),
                       (k10, "dropout")):
        kern["dist_launches_per_step"] = d_launch[name] / N_STEPS

    # dist_training_sage_sharded: owner-side sampling on the sharded graph
    # with the plan's hot structure, the plan's hot features and the
    # peer-hot table; then the same with the int8 store
    runs = {}
    for tag, qz in (("bf16", False), ("int8", True)):
        st = dfs.ShardedFeatureStore(arrays["features"] if qz else features, mesh, hot_ids=f_plan, peer_hot=True,
                                     quantize=qz)
        run = {"store": st, "labels": st.shard_of(labels[:, None]), "gen": torch.Generator(device=cuda).manual_seed(49),
               "trainer": DistTrainer(model=dist_sage(48), fan_out=FAN_OUT, store=st, sgraph=sg, dedup_last=False,
                                      frontier_caps=caps), "ms": [], "mets": []}
        run["trainer"].train_step(None, run["labels"], *train_batches[0], run["gen"])  # warm-up
        runs[tag] = run
    k6_per_hop = 1 + int(sg.hot_indices.numel() > 0)  # the owner's table, and the hot rows
    for rnd in range(4):  # 8 steps of each store in turns; round 0 warms up
        for tag, run in runs.items():
            torch.cuda.synchronize()
            reset_counts()
            mesh.reset_counts()
            t0 = time.perf_counter()
            run["mets"] += [run["trainer"].train_step(None, run["labels"], s, mk, run["gen"])
                            for s, mk in train_batches[1:]]
            torch.cuda.synchronize()
            if rnd:
                run["ms"].append((time.perf_counter() - t0) / N_STEPS * 1e3)
            run["launch"], run["coll"] = read_counts(), dict(mesh.counts)
            check(run["launch"]["sample_uniform"] == k6_per_hop * len(FAN_OUT) * N_STEPS,
                  f"dist_training_sage_sharded {tag}: K6 launches {run['launch']['sample_uniform']}")
    sharded_res = {}
    for tag, run in runs.items():
        mets = run["mets"]
        ovfs = {k: sum(int(m_[k]) for m_ in mets) for k in ("overflow", "sampler_overflow", "frontier_overflow")}
        check(all(v == 0 for v in ovfs.values()), f"dist_training_sage_sharded {tag}: overflow {ovfs}")
        check(all(np.isfinite(float(m_["loss"])) for m_ in mets), f"dist_training_sage_sharded {tag}: loss")
        skern, sprof = profile_device(
            lambda r=run: r["trainer"].train_step(None, r["labels"], *train_batches[1], r["gen"]), iters=3)
        check(bool(skern), f"dist_training_sage_sharded {tag}: the profiler recorded no device activity")
        sharded_res[tag] = {
            "ms_per_step_rounds": run["ms"], "ms_per_step": float(np.median(run["ms"])), "steps": len(mets),
            "losses_first_round": [float(m_["loss"]) for m_ in mets[:N_STEPS]],
            "launches_per_step": {k: v / N_STEPS for k, v in run["launch"].items() if v},
            "collectives_per_step": {k: v / N_STEPS for k, v in run["coll"].items()},
            "exchange_rounds_per_step": run["coll"]["host_syncs"] / N_STEPS, "overflow_over_steps": ovfs,
            "hot_feature_rows": int((run["store"].hot_sorted != INVALID_ID).sum()),
            "profiled_ms_per_step": sprof / 3, "device_busy_share": sum(ms for ms, _ in skern.values()) / sprof,
            "profiler_kept_share": profile_device.kept_share}
    del runs
    emit({"phase": "dist_training_sage_sharded", "world": 1, "backend": mesh.backend, "steps": N_STEPS,
          "batch": BATCH, "frontier_caps": list(caps), "hot_structure_nodes": int((sg.hot_sorted != INVALID_ID).sum()),
          "stores": sharded_res, "single_device_ms_per_step": float(np.median(single_ms)), **card})

    # dist_launches: one GAT step on the replicated graph, one weighted SAGE
    # step on a weighted sharded graph (alias tables per shard: K8)
    gat_d = GAT(100, 128, meta["num_classes"], len(FAN_OUT), num_heads=4, compute_dtype=torch.bfloat16,
                generator=torch.Generator().manual_seed(50), device=cuda)
    gtr = DistTrainer(model=gat_d, fan_out=FAN_OUT, store=store_b, dedup_last=False, frontier_caps=caps)
    ggen = torch.Generator(device=cuda).manual_seed(51)
    gtr.train_step(graph, dlabels, *train_batches[0], ggen)
    torch.cuda.synchronize()
    reset_counts()
    gtr.train_step(graph, dlabels, *train_batches[1], ggen)
    torch.cuda.synchronize()
    gat_launch = read_counts()
    check(gat_launch["gat_fwd"] == gat_launch["gat_bwd"] == 3 and gat_launch["dropout"] == DROPOUT_PER_STEP,
          f"dist GAT step launches {gat_launch}")
    sg_w = ShardedGraph.build(hg_w, mesh)
    wtr_d = DistTrainer(model=dist_sage(52), fan_out=FAN_OUT, store=store_b, sgraph=sg_w, dedup_last=False,
                        frontier_caps=caps)
    wgen_d = torch.Generator(device=cuda).manual_seed(53)
    wtr_d.train_step(None, dlabels, *train_batches[0], wgen_d)
    torch.cuda.synchronize()
    reset_counts()
    wm_d = wtr_d.train_step(None, dlabels, *train_batches[1], wgen_d)
    torch.cuda.synchronize()
    w_launch = read_counts()
    check(w_launch["sample_biased_alias"] == 3 and w_launch["sample_uniform"] == 0
          and w_launch["dropout"] == DROPOUT_PER_STEP, f"dist weighted sharded step launches {w_launch}")
    for kern, name in ((k4, "gat_fwd"), (k5, "gat_bwd")):
        kern["dist_launches_per_step"] = gat_launch[name]
    k8["dist_launches_per_step"] = w_launch["sample_biased_alias"]
    k7["dist_launches_per_step"] = w_launch["sample_biased"]
    k2["dist_launches_per_step"] = d_launch["gather_rows_dma"] / N_STEPS
    emit({"phase": "dist_launches", "gat_step": {k: v for k, v in gat_launch.items() if v},
          "weighted_sharded_sage_step": {k: v for k, v in w_launch.items() if v},
          "weighted_sampler_overflow": int(wm_d["sampler_overflow"]), **card})
    del sg_w, wtr_d, gtr, gat_d

    # dist_inference: the ring walk at world 1 against full_graph_inference
    inf_rows = {}
    for tag, m in (("sage", model), ("gcn", gcn_model), ("gat", gat_model)):
        want_i = full_graph_inference(m, None, hg, features, device=cuda)
        dist_full_graph_inference(m, None, hg, features, mesh)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        got_i = dist_full_graph_inference(m, None, hg, features, mesh)
        torch.cuda.synchronize()
        inf_s = time.perf_counter() - t0
        i_launch = read_counts()
        err = rel_err(got_i, want_i)
        check(got_i.shape == want_i.shape and bool(torch.isfinite(got_i.float()).all()), f"dist_inference {tag}: shape")
        check(err <= LOGITS_BF16_TOL, f"dist_inference {tag}: vs full_graph_inference {err} > {LOGITS_BF16_TOL}")
        check(i_launch["gather_rows"] > 0 and sum(i_launch.values()) == i_launch["gather_rows"],
              f"dist_inference {tag}: launches {i_launch}")
        inf_rows[tag] = {"seconds": inf_s, "edges_per_s": len(FAN_OUT) * hg.num_edges / inf_s,
                         "rel_err_vs_full_graph_inference": err, "k1_launches": i_launch["gather_rows"],
                         "collectives": dict(mesh.counts)}
        del want_i, got_i
    emit({"phase": "dist_inference", "world": 1, "backend": mesh.backend, "num_nodes": hg.num_nodes,
          "num_edges": hg.num_edges, "models": inf_rows, **card})
    dist.destroy_process_group()

    # dist_world2_gloo: two processes on the one card; NCCL refuses two
    # ranks on one GPU, so gloo carries their CUDA tensors (its
    # all_to_all_single, all_reduce and all_gather do on this card's
    # torch; its send/recv do not: scripts/probe_gloo_cuda.py)
    t0 = time.perf_counter()
    w2 = launch(world2_gloo, 2, args=(tuple(caps), hg.num_nodes), backend="gloo", device="cuda", timeout_s=600)
    w2_s = time.perf_counter() - t0
    check([r["rank"] for r in w2] == [0, 1] and all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in w2),
          f"dist_world2_gloo: ranks {[(r['rank'], r['backend'], r['device']) for r in w2]}")
    check(w2[0]["grad"]["loss_dist"] == w2[1]["grad"]["loss_dist"]
          and w2[0]["train"]["losses"] == w2[1]["train"]["losses"],
          "dist_world2_gloo: the ranks disagree on the summed loss")
    emit({"phase": "dist_world2_gloo", "world": 2, "backend": "gloo", "device": "cuda:0", "seconds": w2_s,
          "ranks": w2, "dist_phases_s": time.perf_counter() - t_dist, **card})

    # ---- 17. the distributed host-resident tiers, world 1 on NCCL ----------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        rdv_port = sock.getsockname()[1]
    mesh = initialize_distributed(f"tcp://localhost:{rdv_port}", 0, 1)
    check(mesh.backend == "nccl" and mesh.size == 1, f"dist host world 1: {mesh.backend}, {mesh.size}")
    cpu_mesh1 = Mesh(rank=0, size=1, device=torch.device("cpu"))  # the stores' CPU twins run no collective
    t_dh = time.perf_counter()

    # dist_host_features: the 20% plan's feature hot set, structure on the
    # card, the feature budget from tune_dist_tier
    t0 = time.perf_counter()
    tier_f = tune_dist_tier(hg.indptr, hg.indices, arrays["train_idx"], BATCH, FAN_OUT, 1, hot_ids=f_plan)
    tune_f_s = time.perf_counter() - t0
    dh_store = DistHostFeatureStore(feats_host, mesh, f_plan, miss_budget=tier_f.feat_miss_budget)
    ht_store = HostFeatureStore(feats_host, f_hot, miss_budget=tier_f.feat_miss_budget, device=cuda)
    # (b) assemble_local equals a plain gather of the host matrix, through
    # one K1 launch and no collective (a world of one fetches nothing)
    blk_b, _ = sample_blocks(graph, torch.from_numpy(host_batches[0][0]).to(cuda),
                             torch.ones(BATCH, dtype=torch.bool, device=cuda), FAN_OUT, False,
                             torch.Generator(device=cuda).manual_seed(310), dedup_last=False)
    fr_b, frm_b = blk_b[-1].frontier, blk_b[-1].frontier_mask
    fr_np, frm_np = fr_b.cpu().numpy(), frm_b.cpu().numpy()
    st_b = dh_store.stage(fr_np, frm_np)
    st_b.wait()
    budget_b = dfs.request_budget(fr_b.shape[0], 1, 4.0)
    reset_counts()
    mesh.reset_counts()
    rows_b, drop_b = dh_store.assemble_local(fr_b, frm_b, st_b, budget_b)
    torch.cuda.synchronize()
    asm_launch, asm_coll = read_counts(), dict(mesh.counts)
    want_b = torch.from_numpy(np.where(frm_np[:, None], feats_host[np.where(frm_np, fr_np, 0)], 0))
    check(torch.equal(rows_b.cpu(), want_b) and int(drop_b) == 0,
          f"dist_host_features (b): assemble_local differs from the host matrix (peer_dropped {int(drop_b)})")
    check(0 < st_b.count < int(frm_b.sum()), "dist_host_features (b): both tiers in use")
    check(asm_launch["gather_rows"] == 1 and sum(asm_launch.values()) == 1 and sum(asm_coll.values()) == 0,
          f"dist_host_features (b): assemble_local ran {asm_launch} and collectives {asm_coll}")
    asm_ms = cuda_time_ms(lambda: dh_store.assemble_local(fr_b, frm_b, st_b, budget_b), iters=10)
    # (a) one f32 dropout-0 batch: DistHostTrainer.compute_step against
    # HostTierTrainer.compute_step on the same blocks, rows and keys
    m_a = dist_sage(71, None, 0.0)
    m_b = copy.deepcopy(m_a)
    dh_a = DistHostTrainer(model=m_a, fan_out=FAN_OUT, store=dh_store, dedup_last=False)
    ht_b = HostTierTrainer(model=m_b, fan_out=FAN_OUT, store=ht_store, dedup_last=False, device=cuda)
    lab_b = ht_b.batch_labels(labels_np, *host_batches[0])
    mk_b = torch.from_numpy(host_batches[0][1]).to(cuda)
    ma = dh_a.compute_step(blk_b, dh_store.stage(fr_np, frm_np), lab_b, mk_b,
                           torch.Generator(device=cuda).manual_seed(72))
    mb = ht_b.compute_step(blk_b, ht_store.stage(fr_np, frm_np), lab_b, mk_b,
                           torch.Generator(device=cuda).manual_seed(72))
    dh_loss_err = abs(float(ma["loss"]) - float(mb["loss"])) / max(1.0, abs(float(mb["loss"])))
    dh_grad_err = {n_: share_err(pa.grad, pb.grad) for (n_, pa), (_, pb) in zip(m_a.named_parameters(),
                                                                               m_b.named_parameters())}
    check(dh_loss_err <= LOSS_F32_TOL, f"dist_host_features (a): f32 loss {float(ma['loss'])} vs {float(mb['loss'])}")
    check(all(e <= GRAD_F32_TOL for e in dh_grad_err.values()), f"dist_host_features (a): gradients {dh_grad_err}")
    check(int(ma["peer_dropped"]) == 0, "dist_host_features (a): peer_dropped")
    del m_a, m_b, dh_a, ht_b

    def dist_host_turns(dtr, htr, g, batches, n_timed):
        """``dtr.train_batches`` and ``htr.train_batches`` on the same batches
        in turns (d, h, h, d) after one warm-up call each; returns (dist ms
        per batch per round, host-tier ms per round, the dist run's last
        metrics, launch counts and collectives)."""
        for tr in (dtr, htr):
            tr.train_batches(g, labels_np, batches[:N_WARM], 0)
        d_ms, h_ms, last = [], [], None
        for rnd, order in enumerate(((dtr, htr), (htr, dtr))):
            for tr in order:
                torch.cuda.synchronize()
                reset_counts()
                mesh.reset_counts()
                t0 = time.perf_counter()
                mets = tr.train_batches(g, labels_np, batches[N_WARM:N_WARM + n_timed], 1 + rnd)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / n_timed * 1e3
                if tr is dtr:
                    d_ms.append(ms)
                    last = (mets, read_counts(), dict(mesh.counts))
                else:
                    h_ms.append(ms)
        return d_ms, h_ms, last

    def dist_host_measures(mets, launch, coll, n_timed):
        check(all(int(m_["peer_dropped"]) == 0 and np.isfinite(float(m_["loss"])) for m_ in mets),
              "dist host batches: peer_dropped or a loss not finite")
        out = {"launches_per_batch": {k: v / n_timed for k, v in launch.items() if v},
               "collectives_per_batch": {k: v / n_timed for k, v in coll.items()},
               "host_syncs_per_batch": coll["host_syncs"] / n_timed,
               "losses": [float(m_["loss"]) for m_ in mets]}
        for k in ("sample_ms", "stage_ms", "stage_h2d_ms", "feat_miss", "struct_miss", "struct_remote",
                  "struct_plan_ms", "struct_presample_ms"):
            if k in mets[0]:
                out[k + "_per_batch"] = float(np.mean([m_[k] for m_ in mets]))
        for k in ("feat_overflow", "struct_overflow", "sampler_overflow"):
            if k in mets[0]:
                out[k] = sum(m_[k] for m_ in mets)
        return out

    dh_ms, ht_ms, (dh_mets, dh_launch, dh_coll) = dist_host_turns(
        DistHostTrainer(model=fresh_sage(73), fan_out=FAN_OUT, store=dh_store, dedup_last=False),
        HostTierTrainer(model=fresh_sage(73), fan_out=FAN_OUT, store=ht_store, dedup_last=False, device=cuda),
        graph, host_batches, N_TIMED)
    want = {"sample_uniform": 3, "gather_rows": 1, "gather_mean": 3, "slot_transpose": 2, "gather_mean_bwd": 2,
            "dropout": DROPOUT_PER_STEP}
    check(dh_launch == {k: want.get(k, 0) * N_TIMED for k in counters}, f"dist_host_features launches {dh_launch}")
    check(dh_coll == {"all_to_all": 0, "all_reduce": 3 * N_TIMED + 1, "all_gather": 0, "p2p": 0, "host_syncs": 0},
          f"dist_host_features collectives {dh_coll}")
    dh_res = dist_host_measures(dh_mets, dh_launch, dh_coll, N_TIMED)
    # 2 epochs, then the sampled validation accuracy through eval_batches
    conv_dh = DistHostTrainer(model=fresh_sage(74), fan_out=FAN_OUT, store=dh_store, dedup_last=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_dh = 0
    for ep in range(CONV_EPOCHS):
        order = np.random.default_rng(600 + ep).permutation(arrays["train_idx"]).astype(np.int32)
        ep_batches = [(order[b * BATCH:(b + 1) * BATCH], np.ones(BATCH, bool)) for b in range(len(order) // BATCH)]
        mets_dh = conv_dh.train_batches(graph, labels_np, ep_batches, 700 + ep)
        n_dh += len(ep_batches)
    torch.cuda.synchronize()
    conv_dh_s = time.perf_counter() - t0
    valid = arrays["valid_idx"].astype(np.int32)
    n_vb = -(-len(valid) // BATCH)
    vpad = np.full(n_vb * BATCH, INVALID_ID, np.int32)
    vpad[:len(valid)] = valid
    val_batches = [(vpad[b * BATCH:(b + 1) * BATCH], vpad[b * BATCH:(b + 1) * BATCH] != INVALID_ID)
                   for b in range(n_vb)]
    t0 = time.perf_counter()
    dh_correct, dh_total = conv_dh.eval_batches(None, graph, labels_np, val_batches, 800)
    dh_eval_s = time.perf_counter() - t0
    dh_val = dh_correct / dh_total
    check(dh_total == len(valid), f"dist host eval answered {dh_total} of {len(valid)} seeds")
    check(dh_val >= VAL_ACC_MIN, f"dist host val_acc {dh_val} below {VAL_ACC_MIN}")
    emit({"phase": "dist_host_features", "world": 1, "backend": mesh.backend, "tier": dataclasses.asdict(tier_f),
          "tune_dist_tier_s": tune_f_s, "hot_feature_rows": len(f_hot), "batches": N_TIMED,
          "ms_per_batch_rounds": dh_ms, "ms_per_batch": float(np.median(dh_ms)),
          "host_tier_trainer_ms_per_batch_rounds": ht_ms, "host_tier_trainer_ms_per_batch": float(np.median(ht_ms)),
          **dh_res, "assemble_exact": True, "assemble_event_ms": asm_ms, "assemble_staged_rows": st_b.count,
          "f32_loss_err_vs_host_tier_trainer": dh_loss_err, "f32_grad_share_err_vs_host_tier_trainer": dh_grad_err,
          "epochs": CONV_EPOCHS, "epoch_batches": n_dh, "train_s": conv_dh_s,
          "final_loss": float(mets_dh[-1]["loss"]), "eval_s": dh_eval_s, "val_acc_sampled": dh_val,
          "val_acc_min": VAL_ACC_MIN, "seconds": time.perf_counter() - t_dh, **card})
    for kern, name in ((k6, "sample_uniform"), (k1, "gather_rows"), (k2, "gather_rows_dma"), (k3, "gather_mean"),
                       (k3b, "gather_mean_bwd"), (k4, "gat_fwd"), (k5, "gat_bwd"), (st_k, "slot_transpose"),
                       (k3c, "gather_mean_csr"), (k10, "dropout")):
        kern["dist_host_launches_per_batch"] = dh_launch[name] / N_TIMED

    # dist_host_full: the structure host-resident too, the 20% plan's
    # structure hot set, the budget and deg_cap from tune_dist_tier
    t_full = time.perf_counter()
    t0 = time.perf_counter()
    tier_s = tune_dist_tier(hg.indptr, hg.indices, arrays["train_idx"], BATCH, FAN_OUT, 1, hot_ids=s_plan)
    tune_s_s = time.perf_counter() - t0

    def staged_hops(stores, weighted, rng_base, kgen, name):
        """Each hop of a request on the card against the CPU: plan_hop of
        the card's and the CPU's DistHostCSCStore from one hub seed, then
        sample_staged_hop on injected keys: ids and mask equal (on a
        weighted graph except 2-ulp near-ties, counted); per hop the
        staged rows, hub rows, remote rows, presampling ms and launches."""
        seeds_h, mask_h = host_batches[0]
        hops = []
        for i, kk in enumerate(reversed(FAN_OUT)):
            loc_g, st_g = stores[0].plan_hop(seeds_h, mask_h, kk, np.random.default_rng(rng_base + i))
            loc_c, st_c = stores[1].plan_hop(seeds_h, mask_h, kk, np.random.default_rng(rng_base + i))
            check(np.array_equal(loc_g, loc_c) and st_g.count == st_c.count and st_g.remote == st_c.remote,
                  f"{name} hop {i}: the card's plan differs from the CPU's")
            L = len(seeds_h)
            hot_alias = stores[1].hot_graph.alias_prob is not None
            if weighted and hot_alias:
                hot_key = tuple(x.cpu() for x in alias_key_set(L, kk, False, kgen))
            else:
                hot_key = prng.random_keys(kgen, (L,))
            stg_key = prng.random_keys(kgen, (st_c.count,))
            on_card = (tuple(x.to(cuda) for x in hot_key) if isinstance(hot_key, tuple) else hot_key.to(cuda),
                       stg_key.to(cuda))
            reset_counts()
            nb_g = sample_staged_hop(stores[0].hot_graph, torch.from_numpy(loc_g).to(cuda), st_g, kk, on_card)
            torch.cuda.synchronize()
            hop_launch = read_counts()
            nb_c = sample_staged_hop(stores[1].hot_graph, torch.from_numpy(loc_c), st_c, kk, (hot_key, stg_key))
            bad = ((nb_g.ids.cpu() != nb_c.ids) | (nb_g.mask.cpu() != nb_c.mask)).any(1).nonzero().flatten().tolist()
            if weighted:
                hot_ip = stores[1].hot_graph.indptr.numpy().astype(np.int64)
                hot_pr = stores[1].hot_graph.probs.numpy() if stores[1].hot_graph.probs is not None else None
                st_ip = st_c.graph.indptr.numpy().astype(np.int64)
                st_pr = st_c.graph.probs.numpy()
                staged_pos = {int(p): j for j, p in enumerate(st_c.row_of.tolist())}
                for r in bad:
                    if loc_c[r] != INVALID_ID:  # a hot row: K8
                        ok = hot_alias and k8_tie(hot_ip, hot_pr, loc_c, hot_key[1], kk)(r)
                    else:  # a staged row: K7
                        j = staged_pos.get(r)
                        ok = j is not None and k7_tie(st_ip, st_pr, np.arange(st_c.count), stg_key, kk)(j)
                    check(ok, f"{name} hop {i}: row {r} differs between the card and the CPU")
            else:
                check(not bad, f"{name} hop {i}: rows {bad[:5]} differ between the card and the CPU")
            hops.append({"hop": i, "seeds": L, "hot_rows": int((loc_c != INVALID_ID).sum()),
                         "staged_rows": st_c.count, "hub_rows": int(st_c.is_pre.sum()), "remote_rows": st_c.remote,
                         "staged_edges": st_c.graph.num_edges, "presample_ms": st_c.presample_s * 1e3,
                         "near_tie_rows": len(bad), "launches": {k: v for k, v in hop_launch.items() if v}})
            rl = unique_and_relabel(torch.from_numpy(seeds_h), nb_c.ids, nb_c.mask)
            seeds_h, mask_h = rl.frontier.numpy(), rl.frontier_mask.numpy()
        return hops

    s_args = dict(miss_budget=tier_s.struct_miss_budget, deg_cap=tier_s.deg_cap)
    dgs = DistHostCSCStore(hg, mesh, s_plan, **s_args)
    full_hops = staged_hops((dgs, DistHostCSCStore(hg, cpu_mesh1, s_plan, **s_args)), False, 320,
                            torch.Generator().manual_seed(321), "dist_host_full")
    fh_ms, fht_ms, (fh_mets, fh_launch, fh_coll) = dist_host_turns(
        DistHostTrainer(model=fresh_sage(75), fan_out=FAN_OUT, store=dh_store, gstore=dgs, dedup_last=False),
        HostTierTrainer(model=fresh_sage(75), fan_out=FAN_OUT, store=ht_store,
                        gstore=HostCSCStore(hg, s_hot, device=cuda, **s_args), dedup_last=False, device=cuda),
        None, host_batches, N_TIMED)
    k6_full = fh_launch["sample_uniform"] / N_TIMED
    check(len(FAN_OUT) <= k6_full <= 2 * len(FAN_OUT) and fh_launch["gather_rows"] == N_TIMED,
          f"dist_host_full launches {fh_launch}")
    check(fh_coll["all_to_all"] == 0 and fh_coll["host_syncs"] == 0, f"dist_host_full collectives {fh_coll}")
    fh_res = dist_host_measures(fh_mets, fh_launch, fh_coll, N_TIMED)
    full_s = time.perf_counter() - t_full
    # the weighted graph: K8 on the hot rows (the 5% of nodes of highest
    # degree, as host_tier_biased takes), K7 on the staged rows
    t_w = time.perf_counter()
    wplan = top_deg[None]
    wdgs = DistHostCSCStore(hg_w, mesh, wplan, **s_args)
    w_hops = staged_hops((wdgs, DistHostCSCStore(hg_w, cpu_mesh1, wplan, **s_args)), True, 330,
                         torch.Generator().manual_seed(331), "dist_host_full weighted")
    w_tr = DistHostTrainer(model=fresh_sage(76), fan_out=FAN_OUT, store=dh_store, gstore=wdgs, dedup_last=False)
    w_tr.train_batches(None, labels_np, host_batches[:N_WARM], 0)
    n_w = 4
    torch.cuda.synchronize()
    reset_counts()
    mesh.reset_counts()
    t0 = time.perf_counter()
    w_mets = w_tr.train_batches(None, labels_np, host_batches[N_WARM:N_WARM + n_w], 1)
    torch.cuda.synchronize()
    w_ms = (time.perf_counter() - t0) / n_w * 1e3
    w_launch = read_counts()
    check(w_launch["sample_biased"] > 0 and w_launch["sample_biased_alias"] > 0 and w_launch["sample_uniform"] == 0,
          f"dist_host_full weighted launches {w_launch}")
    w_res = dist_host_measures(w_mets, w_launch, dict(mesh.counts), n_w)
    k7["dist_host_launches_per_batch"] = w_launch["sample_biased"] / n_w
    k8["dist_host_launches_per_batch"] = w_launch["sample_biased_alias"] / n_w
    emit({"phase": "dist_host_full", "world": 1, "backend": mesh.backend, "tier": dataclasses.asdict(tier_s),
          "tune_dist_tier_s": tune_s_s, "hot_structure_nodes": len(s_hot), "hot_feature_rows": len(f_hot),
          "hops_card_equals_cpu": full_hops, "batches": N_TIMED, "ms_per_batch_rounds": fh_ms,
          "ms_per_batch": float(np.median(fh_ms)), "host_tier_trainer_ms_per_batch_rounds": fht_ms,
          "host_tier_trainer_ms_per_batch": float(np.median(fht_ms)), "k6_per_batch": k6_full, **fh_res,
          "seconds": full_s,
          "weighted": {"hot_structure_nodes": len(top_deg), "hops_card_equals_cpu": w_hops, "batches": n_w,
                       "ms_per_batch": w_ms, **w_res, "seconds": time.perf_counter() - t_w}, **card})
    del dgs, wdgs, w_tr, dh_store, ht_store
    dist.destroy_process_group()

    # dist_host_world2_gloo: two spawned ranks on the one card over gloo
    t0 = time.perf_counter()
    w2h = launch(dist_host_world2, 2, args=(hg.num_nodes,), backend="gloo", device="cuda", timeout_s=600)
    w2h_s = time.perf_counter() - t0
    check([r["rank"] for r in w2h] == [0, 1] and all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in w2h),
          f"dist_host_world2_gloo: ranks {[(r['rank'], r['backend'], r['device']) for r in w2h]}")
    check(all(w2h[0]["plans"][p]["losses"] == w2h[1]["plans"][p]["losses"] for p in ("selfless", "selfish")),
          "dist_host_world2_gloo: the ranks disagree on the summed loss")
    emit({"phase": "dist_host_world2_gloo", "world": 2, "backend": "gloo", "device": "cuda:0", "seconds": w2h_s,
          "calibrate_ici_note": "gloo on one card moves CUDA tensors through the host: not an NVLink figure",
          "ranks": w2h, "dist_host_phases_s": time.perf_counter() - t_dh, **card})

    # ---- 18. the two-tier ('host', 'data') mesh ---------------------------
    # two_tier_world1: the mesh (1, 1) on NCCL; its sub-meshes span the world
    # and reuse its group.  The hierarchical exchange and store against K1 and
    # the flat store, DistTrainer on the tuple axis against the flat axis
    ax2 = ("host", "data")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        rdv_port = sock.getsockname()[1]
    t_tt = time.perf_counter()
    mesh = initialize_distributed(f"tcp://localhost:{rdv_port}", 0, 1, hosts=1)
    flat = make_mesh(cuda)  # the flat mesh of the same world
    check(mesh.backend == "nccl" and mesh.shape == (1, 1) and mesh.axis("host").size == mesh.axis("data").size == 1,
          f"two_tier_world1: {mesh.backend}, {mesh.shape}")
    fr, frm = blocks[-1].frontier, blocks[-1].frontier_mask
    Lf = fr.shape[0]
    direct_x = torch.where(frm[:, None], gather.gather_rows(features, torch.where(frm, fr, 0)), 0)
    store_h = dfs.ShardedFeatureStore(features, mesh, axis_name=ax2, hierarchical=True, hot_ids=f_plan, peer_hot=True)
    store_f = dfs.ShardedFeatureStore(features, flat, hot_ids=f_plan, peer_hot=True)
    tt_x = {}
    for tag, kw in (("lossless", {}), ("one_round", {"budget_host": Lf, "lossless": False}),
                    ("lossy_third", {"budget_host": Lf // 3, "lossless": False})):
        mesh.reset_counts()
        reset_counts()
        rows_h, uns_h = dfs.exchange_gather_hier(store_h.features, fr, frm, mesh, store_h.shard_size, **kw)
        torch.cuda.synchronize()
        n_valid = int(frm.sum())
        if tag == "lossy_third":  # the first L/3 valid ids pass stage 1, the rest are dropped and counted
            first = torch.cumsum(frm.int(), 0) <= Lf // 3
            check(torch.equal(rows_h, torch.where(first[:, None], direct_x, 0))
                  and int(uns_h) == max(0, n_valid - Lf // 3),
                  f"two_tier_world1 {tag}: rows or unserved {int(uns_h)}")
        else:
            check(torch.equal(rows_h, direct_x) and int(uns_h) == 0, f"two_tier_world1 {tag}: rows differ from K1")
        tt_x[tag] = {"unserved": int(uns_h), "collectives": mesh.all_counts(), "launches": read_counts(),
                     "ms": cuda_time_ms(lambda: dfs.exchange_gather_hier(store_h.features, fr, frm, mesh,
                                                                         store_h.shard_size, **kw), iters=10)}
    mesh.reset_counts()
    flat.reset_counts()
    rh_s, uh_s = store_h.fetch_local(fr, frm)
    rf_s, uf_s = store_f.fetch_local(fr, frm)
    check(torch.equal(rh_s, rf_s) and torch.equal(rh_s, direct_x) and int(uh_s) == int(uf_s) == 0,
          "two_tier_world1: the hierarchical store differs from the flat store")
    tt_store = {"collectives_hier": mesh.all_counts(), "collectives_flat": dict(flat.counts),
                "hier_ms": cuda_time_ms(lambda: store_h.fetch_local(fr, frm), iters=10),
                "flat_ms": cuda_time_ms(lambda: store_f.fetch_local(fr, frm), iters=10)}
    # the flag column makes the response rows F + 1 wide: K1's odd-width path
    flag_k1 = {}
    idx_all = torch.randperm(Lf, device=cuda).to(torch.int32)
    for tag, width, dt in (("bf16", 100, torch.bfloat16), ("int8_packed", 104, torch.int8)):
        for w in (width, width + 1):
            tbl = torch.zeros((Lf, w), dtype=dt, device=cuda)
            flag_k1[f"{tag}_{w}"] = cuda_time_ms(lambda t=tbl: gather.gather_rows(t, idx_all), iters=20)
    # DistTrainer on the tuple axis against the flat axis: same params, keys and batches
    tt_train = {}
    for tag, (m_, st_kw) in (("tuple", (mesh, dict(axis_name=ax2, hierarchical=True))), ("flat", (flat, {}))):
        st_ = dfs.ShardedFeatureStore(features32, m_, hot_ids=f_plan, peer_hot=True, **st_kw)
        sg_ = ShardedGraph.build(hg, m_, axis_name=st_kw.get("axis_name", "data"), hot_ids=s_plan)
        tr_ = DistTrainer(model=dist_sage(52, None), fan_out=FAN_OUT, store=st_, sgraph=sg_, dedup_last=False,
                          frontier_caps=caps)
        gen_ = torch.Generator(device=cuda).manual_seed(53)
        lab_ = st_.shard_of(labels[:, None])
        m_.reset_counts()
        flat.reset_counts()
        mets_ = [tr_.train_step(None, lab_, s, mk, gen_) for s, mk in train_batches[:3]]
        torch.cuda.synchronize()
        tt_train[tag] = {"losses": [float(x["loss"]) for x in mets_],
                         "params": torch.cat([p.detach().reshape(-1) for p in tr_.model.parameters()]),
                         "collectives": m_.all_counts() if m_ is mesh else {"world": dict(flat.counts)}}
        del st_, sg_, tr_
    # the same kernels on the same rows: equal but for summation order (f32)
    p_err = float((tt_train["tuple"].pop("params") - tt_train["flat"].pop("params")).abs().max())
    l_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(tt_train["tuple"]["losses"], tt_train["flat"]["losses"]))
    check(l_err <= LOSS_F32_TOL and p_err <= GRAD_F32_TOL,
          f"two_tier_world1: DistTrainer on the tuple axis differs from the flat axis: {tt_train}, params {p_err}")
    emit({"phase": "two_tier_world1", "world": 1, "backend": mesh.backend, "shape": list(mesh.shape),
          "frontier_ids": Lf, "exchange_hier": tt_x, "store": tt_store, "k1_flag_column_ms": flag_k1,
          "dist_trainer": tt_train, "loss_rel_err": l_err, "params_max_abs_diff": p_err,
          "bitwise_equal": l_err == 0.0 and p_err == 0.0, "seconds": time.perf_counter() - t_tt, **card})
    del store_h, store_f, direct_x
    dist.destroy_process_group()

    # two_tier_world4_gloo: four spawned ranks on the one card over gloo, the
    # mesh (2, 2); the selfless 20% plan over four ranks and its dist-tier knobs
    t0 = time.perf_counter()
    _, s_plan4, f_plan4 = build_cache_plan(hg, F_DIM, np.array_split(arrays["train_idx"], 4), FAN_OUT, capacity,
                                           policy="selfless", cost=cm, device=cuda)
    tier4 = tune_dist_tier(hg.indptr, hg.indices, arrays["train_idx"], BATCH, FAN_OUT, 4, hot_ids=s_plan4)
    plan4_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w4 = launch(two_tier_world4, 4, args=(tuple(caps), hg.num_nodes, f_plan4, s_plan4, dataclasses.asdict(tier4)),
                backend="gloo", device="cuda", timeout_s=600, hosts=2)
    w4_s = time.perf_counter() - t0
    check([r["rank"] for r in w4] == [0, 1, 2, 3] and all(r["backend"] == "gloo" and r["device"] == "cuda:0"
                                                          and r["shape"] == [2, 2] for r in w4),
          f"two_tier_world4_gloo: ranks {[(r['rank'], r['backend'], r['device'], r['shape']) for r in w4]}")
    check(len({r["grad"]["loss_dist"] for r in w4}) == 1 and len({tuple(r["train"]["losses"]) for r in w4}) == 1
          and len({r["dist_host"]["loss"] for r in w4}) == 1, "two_tier_world4_gloo: the ranks disagree on a loss")
    tt_launch = w4[0]["train"]["launches_per_step"]
    emit({"phase": "two_tier_world4_gloo", "world": 4, "shape": [2, 2], "backend": "gloo", "device": "cuda:0",
          "seconds": w4_s, "plan_s": plan4_s, "tier": dataclasses.asdict(tier4),
          "hot_rows_per_rank": {"features": int((f_plan4[0] != INVALID_ID).sum()),
                                "structure": int((s_plan4[0] != INVALID_ID).sum())},
          "flat_world2_ms_per_step": [r["train"]["ms_per_step"] for r in w2], "ranks": w4, **card})

    # dryrun_multichip: the flagship entry point, four ranks on the card over gloo
    t0 = time.perf_counter()
    dr = dryrun_multichip(4, backend="gloo")
    dr_s = time.perf_counter() - t0
    check(all(np.isfinite(dr[k]) for k in ("loss", "biased_q_loss", "gat_loss", "dist_host_loss"))
          and dr["mesh"] == {"host": 2, "data": 2} and dr["peer_dropped"] == 0, f"dryrun_multichip: {dr}")
    emit({"phase": "dryrun_multichip", "n": 4, "backend": "gloo", "seconds": dr_s, **dr,
          "two_tier_phases_s": time.perf_counter() - t_tt, **card})
    for kern, name in ((k6, "sample_uniform"), (k1, "gather_rows"), (k2, "gather_rows_dma"), (k3, "gather_mean"),
                       (k3b, "gather_mean_bwd"), (k4, "gat_fwd"), (k5, "gat_bwd"), (st_k, "slot_transpose"),
                       (k7, "sample_biased"), (k8, "sample_biased_alias"), (k3c, "gather_mean_csr"),
                       (k10, "dropout")):
        kern["two_tier_launches_per_step"] = tt_launch[name]

    # ---- 19. the apps, the dataset I/O and the scale smoke -------------------
    from dist_gnn_tpu_torch.dataloading.preprocess import (load_dataset, make_ogb_raw_fixture, process_ogb_raw,
                                                          save_dataset)
    from dist_gnn_tpu_torch.examples.graphsage import node_classification as nc_app
    from dist_gnn_tpu_torch.examples.graphsage import node_classification_dist as ncd_app
    from dist_gnn_tpu_torch.scripts import bench_scale

    nc_app.RUN_TIMEOUT_S = 600.0  # both apps' launchers and process groups, as every launch above
    t_apps = time.perf_counter()
    ds_root = tempfile.mkdtemp(prefix="chip_smoke_datasets_")
    try:
        # dataset_io: the bench arrays (with the weights) saved, memmapped back
        # equal, the graph from the memmaps equal to the in-memory one; both raw
        # OGB layouts ingested without pandas
        ds_name = "bench500k"
        ds_arrays = {**arrays, "probs": probs_np}
        ds_meta = {**meta, "name": ds_name}
        t0 = time.perf_counter()
        save_dataset(ds_root, ds_name, ds_arrays, ds_meta)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, lmeta = load_dataset(ds_root, ds_name, mmap=True)
        check(sorted(loaded) == sorted(ds_arrays) and lmeta == ds_meta, f"dataset_io: loaded {sorted(loaded)}")
        for k, v in ds_arrays.items():
            lv = loaded[k]
            check(isinstance(lv, np.memmap) and not lv.flags.writeable and lv.dtype == v.dtype
                  and np.array_equal(lv, v), f"dataset_io: {k} loads back different")
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the read-only memmaps reach torch by a copy
            g_mm = HostGraph(indptr=loaded["indptr"], indices=loaded["indices"]).to_device(cuda)
        check(g_mm.max_degree == graph.max_degree and g_mm.indptr.dtype == graph.indptr.dtype
              and torch.equal(g_mm.indptr, graph.indptr) and torch.equal(g_mm.indices, graph.indices),
              "dataset_io: the graph from the memmaps differs from the in-memory one")
        load_s = time.perf_counter() - t0
        ds_bytes = sum(os.path.getsize(os.path.join(ds_root, ds_name, f)) for f in os.listdir(os.path.join(ds_root, ds_name)))
        del g_mm, loaded
        ogb = {}
        # any import of pandas fails while the raw layouts are ingested
        with mock.patch.dict(sys.modules, {"pandas": None}):
            for oname in ("ogbn-products", "ogbn-papers100M"):
                raw = os.path.join(ds_root, "raw_" + oname)
                n_o = 2000
                src_o, dst_o, feats_o, labels_o, split_o = make_ogb_raw_fixture(raw, oname, seed=0, n=n_o)
                t0 = time.perf_counter()
                oa, om = process_ogb_raw(raw, oname, ds_root, with_probs=True)
                o_s = time.perf_counter() - t0
                sym = oname == "ogbn-products"
                dst_all = np.concatenate([dst_o, src_o]) if sym else dst_o
                check(om["num_nodes"] == n_o and om["num_edges"] == len(dst_all) and om["feature_dim"] == 8
                      and om["num_classes"] == int(np.nan_to_num(labels_o).max()) + 1, f"dataset_io {oname}: meta {om}")
                check(oa["indptr"].shape == (n_o + 1,) and oa["indices"].dtype == np.int32
                      and np.array_equal(np.diff(oa["indptr"]), np.bincount(dst_all, minlength=n_o))
                      and oa["features"].dtype == np.float32 and np.array_equal(oa["features"], feats_o)
                      and oa["labels"].dtype == np.int32
                      and np.array_equal(oa["labels"], np.nan_to_num(labels_o).astype(np.int32))
                      and oa["probs"].dtype == np.float32 and oa["probs"].shape == (len(dst_all),)
                      and all(oa[f"{k}_idx"].dtype == np.int32 and np.array_equal(oa[f"{k}_idx"], split_o[k])
                              for k in ("train", "valid", "test")),
                      f"dataset_io {oname}: shapes, dtypes or values")
                ogb[oname] = {**om, "symmetrized": sym, "seconds": o_s,
                              "dtypes": {k: str(v.dtype) for k, v in oa.items()}}
        emit({"phase": "dataset_io", "name": ds_name, "arrays": {k: [list(v.shape), str(v.dtype)]
                                                                  for k, v in ds_arrays.items()},
              "bytes_on_disk": ds_bytes, "save_s": save_s, "load_mmap_and_upload_s": load_s,
              "loaded_equal": True, "memmap_graph_equal": True, "ogb_raw": ogb,
              "pandas_installed": importlib.util.find_spec("pandas") is not None, "ingested_with_pandas_blocked": True,
              "seconds": time.perf_counter() - t_apps, **card})

        # app_sage: node_classification.main on the saved dataset at the bench
        # config, then a resumed epoch from its checkpoint
        common = ["--dataset", ds_name, "--root", ds_root, "--fan-out", ",".join(map(str, FAN_OUT)),
                  "--batch-size", str(BATCH), "--bf16"]
        ck = os.path.join(ds_root, "ck", "sage")
        mlog = os.path.join(ds_root, "metrics.jsonl")
        sage_argv = common + ["--hidden", "256", "--epochs", "2", "--autotune", "--full-eval", "--checkpoint", ck,
                              "--metrics-log", mlog]
        reset_counts()
        t0 = time.perf_counter()
        sage_res = nc_app.main(sage_argv)
        sage_s = time.perf_counter() - t0
        sage_launch = read_counts()
        with open(mlog) as f:
            events = [json.loads(line) for line in f]
        sage_val = sage_res["epochs"][-1]["val_acc"]
        check(sage_val >= VAL_ACC_MIN, f"app_sage: val_acc {sage_val} below {VAL_ACC_MIN}")
        check(sage_res["test_acc"] is not None and sage_res["test_acc"] >= VAL_ACC_MIN,
              f"app_sage: full-graph test accuracy {sage_res['test_acc']}")
        check(sage_res["param_devices"] == ["cuda:0"], f"app_sage: parameters on {sage_res['param_devices']}")
        check([e["event"] for e in events] == ["epoch", "epoch", "full_eval"]
              and all(set(e) == {"event", "ts", "epoch", "loss", "train_acc", "time_s"} for e in events[:2])
              and set(events[2]) == {"event", "ts", "test_acc"}, f"app_sage: metrics log {events}")
        check(all(sage_launch[k] > 0 for k in ("sample_uniform", "gather_rows", "gather_mean", "slot_transpose",
                                              "gather_mean_bwd", "dropout")), f"app_sage: launches {sage_launch}")
        sage_steps = sum(e["steps"] for e in sage_res["epochs"])
        reset_counts()
        t0 = time.perf_counter()
        resumed = nc_app.main(common + ["--hidden", "256", "--epochs", "1", "--resume", ck])
        resume_s = time.perf_counter() - t0
        check(resumed["step"] == sage_res["step"] + resumed["epochs"][0]["steps"] and sage_res["step"] == sage_steps,
              f"app_sage: the resumed run's step {resumed['step']} does not carry on from {sage_res['step']}")
        check(all(math.isfinite(e["loss"]) for e in resumed["epochs"]), "app_sage: resumed loss not finite")
        emit({"phase": "app_sage", "argv": sage_argv, "epochs": sage_res["epochs"],
              "ms_per_step": [e["time_s"] / e["steps"] * 1e3 for e in sage_res["epochs"]],
              "trainer_ms_per_step_training_sage": trainer_ms_per_step["training_sage"],
              "test_acc": sage_res["test_acc"], "step": sage_res["step"], "metrics_events": [e["event"] for e in events],
              "launches": sage_launch, "train_steps": sage_steps,
              "launches_per_train_step": {k: sage_launch[k] / sage_steps
                                          for k in ("slot_transpose", "gather_mean_bwd", "dropout")},
              "seconds": sage_s,
              "resume": {"step": resumed["step"], "epochs": resumed["epochs"], "seconds": resume_s}, **card})

        # app_variants: one epoch each of the other modes on the same dataset
        variants = {"gat": ["--model", "gat", "--hidden", "128"], "gcn": ["--model", "gcn"], "bias": ["--bias"],
                    "unroll4": ["--unroll", "4"], "profile": ["--profile"], "tier_host": ["--tier", "host"],
                    "tier_host_struct": ["--tier", "host", "--host-struct"], "tier_dist_host": ["--tier", "dist-host"],
                    "dist": ["--dist"]}
        var_out = {}
        for tag, extra in variants.items():
            spawned = tag in ("tier_dist_host", "dist")
            argv = common + ["--epochs", "1"] + ([] if "--hidden" in extra else ["--hidden", "256"]) + extra
            reset_counts()
            t0 = time.perf_counter()
            r = nc_app.main(argv)
            run_s = time.perf_counter() - t0
            lc = None if spawned else read_counts()
            (ep,) = r["epochs"]
            check(math.isfinite(ep["loss"]) and ep["steps"] > 0, f"app_variants {tag}: {ep}")
            check(r["world"] == 1 and r["device"] == "cuda:0", f"app_variants {tag}: world {r['world']} on {r['device']}")
            want = {"gat": ("gat_fwd", "gat_bwd", "sample_uniform", "gather_rows", "dropout"),
                    "bias": ("sample_biased_alias",), "gcn": ("sample_uniform", "gather_rows", "dropout")}.get(tag, () if spawned else ("sample_uniform",))
            check(lc is None or all(lc[k] > 0 for k in want), f"app_variants {tag}: launches {lc}")
            if tag == "profile":
                check(r["profile"] is not None and all(v >= 0 for v in r["profile"].values()),
                      f"app_variants profile: {r['profile']}")
            var_out[tag] = {"argv_extra": extra, "time_s": ep["time_s"], "steps": ep["steps"],
                            "ms_per_step": ep["time_s"] / ep["steps"] * 1e3, "loss": ep["loss"],
                            "val_acc": ep["val_acc"], "train_acc": ep["train_acc"], "profile_ms": r["profile"],
                            "feat_miss_per_batch": ep.get("feat_miss"), "launches": lc, "seconds": run_s}
        emit({"phase": "app_variants", "variants": var_out, **card})

        # app_dist: node_classification_dist.main on (2, 2) over gloo on the one
        # card at the app's defaults
        dist_out = {}
        for tag, argv, world, shape, backend in (
                ("world4_hbm", ["--procs", "2", "--devices-per-process", "2", "--tier", "hbm"], 4, [2, 2], "gloo"),
                ("world4_dist_host", ["--procs", "2", "--devices-per-process", "2", "--tier", "dist-host"],
                 4, [2, 2], "gloo")):
            t0 = time.perf_counter()
            r = ncd_app.main(argv)
            run_s = time.perf_counter() - t0
            check(r["world"] == world and r["shape"] == shape and r["backend"] == backend and r["device"] == "cuda:0"
                  and all(math.isfinite(e["loss"]) and 0.0 <= e["val_acc"] <= 1.0 for e in r["epochs"]),
                  f"app_dist {tag}: {r}")
            dist_out[tag] = {"argv": argv, "world": world, "shape": shape, "backend": backend, "batch": r["batch"],
                             "num_edges": r["num_edges"], "epochs": r["epochs"],
                             "ms_per_step": [e["time_s"] / e["steps"] * 1e3 for e in r["epochs"]], "seconds": run_s}
        emit({"phase": "app_dist", "runs": dist_out, **card})

        # scale: the bench config on 500k and 2M nodes of the same degree, one
        # measurement at each size (scripts/bench_scale.py)
        t0 = time.perf_counter()
        scale_runs = [bench_scale.run(n, 15) for n in (500_000, 2_000_000)]
        for sc in scale_runs:
            check(sc["edges_per_step"] > 0 and math.isfinite(sc["step_ms"]) and sc["step_ms"] > 0, f"scale: {sc}")
        emit({"phase": "scale", "runs": scale_runs,
              "step_ms_2m_over_500k": scale_runs[1]["step_ms"] / scale_runs[0]["step_ms"],
              "seconds": time.perf_counter() - t0, "apps_phases_s": time.perf_counter() - t_apps, **card})
    finally:
        shutil.rmtree(ds_root, ignore_errors=True)

    # ---- 15. kernels, card, result ----------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "dist_launches_per_step",
            "dist_host_launches_per_batch", "two_tier_launches_per_step")
    # the profiler's record check saw launches (else it could not work)
    check(profile_device.launches_seen > 0, "the profiler recorded no kernel launch calls")
    emit({"phase": "profiler", "sessions": profile_device.sessions,
          "sessions_incomplete": profile_device.sessions_incomplete,
          "min_kept_share": profile_device.min_kept_share, "launches_seen": profile_device.launches_seen,
          **card})
    emit({"kernels": [{**{k: kern[k] for k in keys}, **{k: kern[k] for k in ("launches_count", "hops", "all_hub") if k in kern}}
                      for kern in (k6, k1, k2, k3, k3b, k3c, k4, k5, k9, k9b, k10, st_k, k7, k8)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
