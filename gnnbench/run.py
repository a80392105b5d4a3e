"""The benchmark of ``dist_gnn_tpu_torch``: one run of one cell.

    python3 gnnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program.  Prints, as its last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, ``setup_parts`` (the kernel build's seconds, which
``setup_s`` includes: only a checkout's first run builds), and last
``checks``, each number compared with its limit;
the same numbers are the last lines of standard error.  Exits non-zero and
prints no result without enough CUDA devices, or when a module of JAX or
of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "gnnbench" / "_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from gnnbench import harness

    cell, _ = harness.find_cell(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gnnbench: {args.workload} needs {cell['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    from dist_gnn_tpu_torch.kernels import build

    t_build = time.perf_counter()
    build.build_all()  # every library in parallel; a no-op once built
    build_s = time.perf_counter() - t_build
    print(f"gnnbench: kernel build {build_s:.3f} s (inside setup_s, reported apart as setup_parts.build_s)",
          file=sys.stderr, flush=True)
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START, setup_parts={"build_s": build_s})
    found = harness.forbidden_modules()
    if found:
        print("gnnbench: modules of JAX or the JAX package were loaded: " + ", ".join(found), file=sys.stderr)
        return 3
    for name, value in line["readings"].items():
        print(f"reading {name} = {value!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
