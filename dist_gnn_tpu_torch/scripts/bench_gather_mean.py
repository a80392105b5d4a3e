"""K3 (the masked neighbour mean) and its backward at the SAGE bench
config's layers, each call timed three ways.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_gather_mean

The blocks are those of ``chip_smoke.py``: the 500k-node
``make_synthetic_dataset(seed=0)`` graph, 512 validation seeds, fanout
(15, 10, 5) with a dedup-free last hop, hop keys from ``Generator(1)``.
Layer 0 aggregates the gathered bf16 features (F 100), layers 1 and 2 a
random bf16 [cap, 256] (``Generator(2)``); the backward runs at layers 1
and 2 on a random bf16 d_out (``Generator(3)``), as a SAGE step does.

Per call: ``ms``, CUDA events around 20 back-to-back calls (what the
``PERF.md`` table calls event ms); ``device_ms``, the profiler's time of
every kernel, memset and copy the call puts on the card, and their names;
``host_us_per_call``, the host clock around 200 back-to-back calls with no
synchronize.  ``bound_ms``: the bytes the function must move over
3.35 TB/s.  K3 is timed without a gradient (a request, and layer 0 of a
step) and, at layers 1 and 2, as a step calls it (``train_form``: h needs
a gradient); K3's backward alone (``gather_mean_bwd``) and as a step's
backward runs it (``as_a_step``: the backward of a training-form
output's autograd node, called directly, without the autograd engine's
own cost, which a step pays once for all its nodes).  ``per_step`` adds up what one SAGE step runs: K3 at layer 0,
the training form at layers 1 and 2, and the two backwards as a step.
``host_parts_us`` times pieces of a launch path alone.

The script reads only the public wrappers, so it also runs against an
older tree of the package: ``PYTHONPATH=<that tree> python3 <this file>``.
``chip_smoke.py`` times K3 and K3-bwd with :func:`layer_inputs` and
:func:`measure`.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time
from typing import Callable, Dict, List

import torch

from dist_gnn_tpu_torch.ops import gather

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FAN_OUT = (15, 10, 5)
BATCH = 512
HIDDEN = 256
HOST_CALLS = 200


def time_call(fn: Callable[[], object], iters: int = 20, prof_iters: int = 10) -> Dict:
    """Event ms, device ms (every device activity of a call) and host µs
    per call of ``fn``."""
    from dist_gnn_tpu_torch.utils.timing import cuda_time_ms, profile_device

    ms = cuda_time_ms(fn, iters=iters)
    kernels, _ = profile_device(fn, iters=prof_iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return {
        "ms": ms,
        "device_ms": sum(v for v, _ in kernels.values()) / prof_iters if kernels else None,
        "device_ops_per_call": sum(n for _, n in kernels.values()) / prof_iters,
        "device_ms_by_op": {name[:60]: v / prof_iters for name, (v, _) in kernels.items()},
        "host_us_per_call": host_us,
    }


def _host_us(fn: Callable[[], object], n: int = 2000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def host_parts(h: torch.Tensor, slots: torch.Tensor, mask: torch.Tensor) -> Dict[str, float]:
    """Host µs of pieces of a K3 launch, each alone: the current stream
    object, an empty output, a ctypes call of the K3 entry point that
    returns at once (S = 0), and a call of ``torch.autograd.Function``'s
    ``apply`` on an identity."""

    class _Identity(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x

        @staticmethod
        def backward(ctx, g):
            return g

    S, F = slots.shape[0], h.shape[1]
    lib = gather._lib()
    parts = {
        "current_stream": _host_us(lambda: torch.cuda.current_stream().cuda_stream),
        "torch_empty_out": _host_us(lambda: torch.empty((S, F), dtype=h.dtype, device=h.device)),
        "new_empty_out": _host_us(lambda: h.new_empty((S, F))),
        "autograd_function_apply": _host_us(lambda: _Identity.apply(h)),
        "data_ptr_x4": _host_us(lambda: (h.data_ptr(), slots.data_ptr(), mask.data_ptr(), h.data_ptr())),
    }
    fn = lib.dg_gather_mean
    args = (0, 0, 0, 0, 1, 0, 1, 1, 1) + (0,) * (len(fn.argtypes) - 9)  # S = 0: returns at once
    parts[f"ctypes_call_{len(args)}_args"] = _host_us(lambda: fn(*args))
    parts["raw_current_stream"] = _host_us(lambda: torch._C._cuda_getCurrentRawStream(h.get_device()))
    parts["current_device"] = _host_us(torch.cuda.current_device)
    # the floor of any ctypes launch: a foreign call of a C function with
    # no arguments (abs(0) from the C library)
    libc_abs = ctypes.CDLL(None).abs
    parts["ctypes_call_floor"] = _host_us(lambda: libc_abs(0))
    return parts


def bench_blocks(device: torch.device):
    """The blocks, frontier features and card line of ``chip_smoke.py``'s
    serving request."""
    from dist_gnn_tpu_torch.dataloading.preprocess import make_synthetic_dataset
    from dist_gnn_tpu_torch.graph import HostGraph
    from dist_gnn_tpu_torch.ops import prng
    from dist_gnn_tpu_torch.sampler import layer_capacities, sample_blocks

    arrays, _ = make_synthetic_dataset(num_nodes=500_000, avg_degree=30, feature_dim=100,
                                       num_classes=47, train_frac=0.2, seed=0)
    graph = HostGraph(indptr=arrays["indptr"], indices=arrays["indices"]).to_device(device)
    features = torch.from_numpy(arrays["features"]).to(device, torch.bfloat16)
    seeds = torch.from_numpy(arrays["valid_idx"][:BATCH]).to(device)
    key_gen = torch.Generator().manual_seed(1)
    hop_keys = [prng.random_keys(key_gen, (b,)).to(device)
                for b in layer_capacities(BATCH, FAN_OUT)[: len(FAN_OUT)]]
    blocks, _ = sample_blocks(graph, seeds, torch.ones(BATCH, dtype=torch.bool, device=device),
                              FAN_OUT, False, hop_keys, dedup_last=False)
    safe = torch.where(blocks[-1].frontier_mask, blocks[-1].frontier, 0)
    return blocks, gather.gather_rows(features, safe)


def layer_inputs(blocks, feats: torch.Tensor) -> List[Dict]:
    """Per SAGE layer, input first: its h, slots, mask and (layers 1 and 2,
    whose input needs a gradient in a step) a d_out."""
    dev = feats.device
    hgen = torch.Generator(device=dev).manual_seed(2)
    dgen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for l, blk in enumerate(reversed(blocks)):
        h = feats if l == 0 else torch.randn(blk.num_src, HIDDEN, device=dev, generator=hgen).to(torch.bfloat16)
        S = blk.neigh_slots.shape[0]
        d_out = None if l == 0 else torch.randn(S, HIDDEN, device=dev, generator=dgen).to(torch.bfloat16)
        out.append({"layer": l, "h": h, "slots": blk.neigh_slots, "mask": blk.neigh_mask, "d_out": d_out})
    return out


def measure(inputs: List[Dict]) -> Dict:
    """K3 per layer (plus the training form at layers 1 and 2) and K3-bwd at
    layers 1 and 2 (alone and as a step), each with :func:`time_call` and
    its bound; for K3-bwd also how many source rows more than 32 valid
    slots name, and the most any row is named; and the sum of one step."""
    k3, k3b = [], []
    per_step = dict.fromkeys(("ms", "device_ms", "host_us_per_call"), 0.0)
    for x in inputs:
        l, h, slots, m, d_out = x["layer"], x["h"], x["slots"], x["mask"], x["d_out"]
        S, k = slots.shape
        F = h.shape[1]
        rows = int(torch.unique(slots[m]).numel())
        nbytes = rows * F * 2 + S * k * 5 + S * F * 2
        lay = {"layer": l, "S": S, "k": k, "F": F, "cap": h.shape[0], "valid_slots": int(m.sum()),
               "distinct_rows": rows, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        lay.update(time_call(lambda: gather.gather_mean(h, slots, m)))
        k3.append(lay)
        if d_out is None:  # layer 0's input, the gathered features, needs no gradient
            continue
        hg = h.detach().requires_grad_(True)
        lay["train_form"] = time_call(lambda: gather.gather_mean(hg, slots, m))
        if l == 1:
            lay["host_parts_us"] = host_parts(h, slots, m)
        cap = h.shape[0]
        nb = S * HIDDEN * 2 + S * k * 5 + cap * HIDDEN * 2
        named = torch.bincount(slots[m].long(), minlength=cap)
        lay_b = {"layer": l, "S": S, "k": k, "F": HIDDEN, "cap": cap, "valid_slots": lay["valid_slots"],
                 "rows_named_over_32": int((named > 32).sum()), "most_named": int(named.max()),
                 "bytes": nb, "bound_ms": nb / HBM_BYTES_PER_S * 1e3}
        lay_b.update(time_call(lambda: gather.gather_mean_bwd(d_out, slots, m, cap)))
        y = gather.gather_mean(hg, slots, m)
        lay_b["as_a_step"] = time_call(lambda: y.grad_fn.apply(d_out))
        k3b.append(lay_b)
        for part in (lay["train_form"], lay_b["as_a_step"]):
            for key in per_step:
                per_step[key] += part[key] or 0.0
    for key in per_step:  # and layer 0's K3, without a gradient
        per_step[key] += k3[0][key] or 0.0
    return {"k3": k3, "k3_bwd": k3b, "per_step": per_step}


def main() -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gather_mean needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res = measure(layer_inputs(*bench_blocks(dev)))
    for name in ("k3", "k3_bwd"):
        for lay in res[name]:
            print(json.dumps({"kernel": name, **lay, "card": smi}), flush=True)
    summary = {name: {key: sum(lay[key] or 0.0 for lay in res[name])
                      for key in ("ms", "device_ms", "host_us_per_call", "bound_ms")}
               for name in ("k3", "k3_bwd")}
    print(json.dumps({"summary": summary, "per_step": res["per_step"], "card": smi}), flush=True)
    return res


if __name__ == "__main__":
    main()
