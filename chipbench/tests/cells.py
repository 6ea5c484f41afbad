"""Small cells for the CPU tests: a cell of ``BENCHMARK.json`` with its
configuration cut to the sizes of ``ArchConfig.reduced`` and its traffic to a
few short rows."""

from __future__ import annotations

import dataclasses

from chipbench import harness

SMALL = dict(d_model=64, n_heads=4, d_ff=128, vocab_size=128, head_dim=16)


def small_cfg(cfg: dict) -> dict:
    return dict(cfg, **SMALL, n_layers=2, n_kv_heads=2 if cfg["n_kv_heads"] < cfg["n_heads"] else 4)


def small_cell(workload: str, rows: int = 2, length: int = 32, **traffic) -> harness.Cell:
    """The cell ``workload`` at reduced sizes, ``rows`` x ``length`` tokens a
    batch; a train cell in float32 (at these sizes bf16 rounding alone reads
    above the full-size training limits)."""
    cell = harness.resolve(workload)
    tr = dict(cell.traffic, rows=rows, length=length, pool_batches=8, **traffic)
    if tr["entry"] == "score":
        tr.update(check_rows=min(tr["check_rows"], 4), reference_rows=2)
        cfg = small_cfg(cell.cfg)
    else:
        tr.update(microbatches=min(tr["microbatches"], rows))
        cfg = dict(small_cfg(cell.cfg), param_dtype="float32", activation_dtype="float32")
    return dataclasses.replace(cell, cfg=cfg, traffic=tr)
