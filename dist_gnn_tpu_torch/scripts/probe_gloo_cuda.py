"""Which collectives of the distributed package gloo carries for CUDA
tensors on this machine.

Two ranks on one card can only meet over gloo (NCCL refuses two ranks on
one GPU), so a world of two on a single H100 needs gloo to carry CUDA
tensors.  For each collective the port uses (``all_reduce``,
``all_to_all_single``, ``batch_isend_irecv``, ``all_gather``) this starts
a fresh interpreter that spawns a gloo world of two on ``cuda:0``, runs
the collective through ``parallel.mesh.Mesh`` on CUDA tensors of the
payload dtypes (int32, bf16, int8, f32; f64 and int64 for the sums),
checks the values and exits; a rank that gloo aborts takes only its own
interpreter down.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.probe_gloo_cuda

One JSON line per collective (``ok``, and the end of the error output when
not), then a summary line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict

import torch

OPS = ("all_reduce", "all_to_all", "p2p", "all_gather")
DTYPES = (torch.int32, torch.bfloat16, torch.int8, torch.float32)


def _run_op(mesh, op: str) -> bool:
    dev, r, n = mesh.device, mesh.rank, mesh.size
    if op == "all_reduce":
        for dt in (torch.float64, torch.int64, torch.float32):
            t = torch.full((5,), r + 1, dtype=dt, device=dev)
            if not bool((mesh.all_reduce(t) == n * (n + 1) // 2).all()):
                raise RuntimeError(f"all_reduce {dt}: wrong sum")
    for dt in DTYPES if op != "all_reduce" else ():
        x = (torch.arange(4 * n, device=dev).reshape(n, 4) + 10 * r).to(dt)
        if op == "all_to_all":
            got, want = mesh.all_to_all(x), torch.stack([x[r] - 10 * r + 10 * j for j in range(n)])
        elif op == "p2p":
            got, want = mesh.shift(x), x - 10 * r + 10 * ((r + 1) % n)
        else:
            got, want = torch.stack(mesh.all_gather(x)), torch.stack([x - 10 * r + 10 * j for j in range(n)])
        if not torch.equal(got.cpu(), want.to(dt).cpu()):
            raise RuntimeError(f"{op} {dt}: wrong values")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return True


def probe(op: str, timeout_s: float = 120.0) -> Dict[str, object]:
    """Run one collective in a fresh interpreter; its verdict and, on
    failure, the last lines of its error output."""
    try:
        res = subprocess.run([sys.executable, "-m", "dist_gnn_tpu_torch.scripts.probe_gloo_cuda", "--op", op],
                             capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"op": op, "ok": False, "error": f"no answer in {timeout_s} s"}
    ok = res.returncode == 0 and "ok" in res.stdout.split()
    out = {"op": op, "ok": ok}
    if not ok:
        # the aborted rank's message, then the launcher's (each once)
        lines = [ln.strip() for ln in res.stderr.splitlines() if any(w in ln for w in ("what()", "Error", "Exception"))]
        out["returncode"] = res.returncode
        out["error"] = " | ".join(dict.fromkeys(lines))[-900:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", choices=OPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    if args.op:
        from dist_gnn_tpu_torch.parallel.mesh import launch

        launch(_run_op, 2, args=(args.op,), backend="gloo", device="cuda", timeout_s=90)
        print("ok", flush=True)
        return 0
    results = [probe(op) for op in OPS]
    for r in results:
        print(json.dumps(r), flush=True)
    print(json.dumps({"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
                      "gloo_carries_cuda": {r["op"]: r["ok"] for r in results}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
