"""Feature-row gather microbenchmark with full consumption.

Counterpart of ``scripts/bench_gather2.py``.  Run on the card:

    python3 -m dist_gnn_tpu_torch.scripts.bench_gather2

A [N, F] table, random from a seeded ``torch.Generator``, in bf16 and in an
f32 copy, and L random ids, at the JAX script's shapes (N = 500,000,
F = 128, L = 540,672).  K2 is first checked against ``table[idx]``,
exactly, on 4096 ids.  Then every variant is timed with
:func:`~dist_gnn_tpu_torch.utils.timing.measure_chain`: step i gathers
``torch.roll(idx, i)`` and folds the f32 sum of the whole output into the
carry, so each step consumes its gather in full, as the JAX script's steps
do.  A step's time therefore includes the roll (2 MB) and the sum (one
read of the output).

Variants: ``index_select`` on bf16 and on f32, K1 on bf16, and K2 on bf16
and on f32 for ``rows_per_step`` in (32, 128, 256, 512).  A K2 variant
whose two stages do not fit in a block's shared memory is not launched,
and its line names the limit.  One line per variant: ms per step, M rows/s
and GB/s (L rows of the variant's row bytes written per step).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dist_gnn_tpu_torch.ops.gather import (
    dma_stage_bytes,
    gather_rows,
    gather_rows_dma,
    smem_optin_bytes,
)
from dist_gnn_tpu_torch.utils.device import DeviceLike, resolve_device
from dist_gnn_tpu_torch.utils.timing import measure_chain

N = 500_000
F = 128
L = 540_672
ROWS_PER_STEP = (32, 128, 256, 512)
CHECK_IDS = 4096
SEED = 0


def main(device: DeviceLike = None, n: int = N, f: int = F, l: int = L) -> List[Dict]:
    """Check K2, then time every variant and print one line each.  Runs on
    the card unless ``device="cpu"`` (where every wrapper takes its plain
    version and the times are host times); raises without a card.  ``n``,
    ``f`` and ``l`` shrink the shapes for a quick run.  Returns one dict
    per variant."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
    table32 = table.float()
    idx = torch.randint(0, n, (l,), generator=gen, device=dev, dtype=torch.int32)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}  "
          f"N={n} F={f} L={l}", flush=True)

    check = idx[:CHECK_IDS]
    for t in (table32, table):
        if not torch.equal(gather_rows_dma(t, check), t[check.long()]):
            raise RuntimeError(f"K2 differs from table[idx] on {t.dtype}")
    print("k2 correctness OK", flush=True)

    limit = smem_optin_bytes(dev) if dev.type == "cuda" else None
    results: List[Dict] = []

    def bench(name: str, t: torch.Tensor, fn, rows_per_step=None) -> None:
        row_bytes = t.shape[1] * t.element_size()
        res = {"variant": name, "rows_per_step": rows_per_step, "row_bytes": row_bytes}
        need = None if rows_per_step is None else dma_stage_bytes(row_bytes, rows_per_step)
        if limit is not None and need is not None and need > limit:
            res.update(launched=False, smem_bytes=need, smem_limit=limit)
            print(f"{name}: not launched: two stages of {rows_per_step} x {row_bytes} B rows "
                  f"need {need} B of shared memory, above the {limit} B a block may opt in to",
                  flush=True)
            results.append(res)
            return

        def step(carry):
            i, acc = carry
            out = fn(torch.roll(idx, i))
            return i + 1, acc + out.sum(dtype=torch.float32)

        dt = measure_chain(step, (0, torch.zeros((), device=dev)))
        res.update(launched=True, ms=dt * 1e3, m_rows_per_s=l / dt / 1e6,
                   gb_per_s=l * row_bytes / dt / 1e9)
        print(f"{name}: {res['ms']:.4f} ms  {res['m_rows_per_s']:.1f}M rows/s  "
              f"{res['gb_per_s']:.1f} GB/s", flush=True)
        results.append(res)

    bench("index_select_bf16", table, lambda ids: torch.index_select(table, 0, ids))
    bench("index_select_f32", table32, lambda ids: torch.index_select(table32, 0, ids))
    bench("k1_bf16", table, lambda ids: gather_rows(table, ids))
    for t, tag in ((table, "bf16"), (table32, "f32")):
        for b in ROWS_PER_STEP:
            bench(f"k2_{tag}_b{b}", t, lambda ids, t=t, b=b: gather_rows_dma(t, ids, rows_per_step=b), b)
    return results


if __name__ == "__main__":
    main()
