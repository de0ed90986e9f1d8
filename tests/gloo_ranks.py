"""Runs a function on the ranks of a CPU ``gloo`` process group, one spawned
process per rank, for the tests of the process-group form of
``repro_torch.core.halo`` and ``repro_torch.core.seq_halo``.

The group meets through a file store under the test's ``tmp_path`` (no
port to collide with other test workers); every wait has a limit, so a
rank that hangs fails the test instead of holding the suite.
"""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GLOO_TIMEOUT_S = 60     # a collective that waits longer raises in the rank
RUN_TIMEOUT_S = 180     # the whole run, spawning included


def _rank(rank: int, n: int, tmp: str, target, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        out = target(dist.group.WORLD, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{tmp}/rank{rank}.pt")


def run_ranks(target, n: int, tmp_path: Path, *args) -> list:
    """``target(group, *args)`` on each of ``n`` ranks; returns the ranks'
    results in rank order.  ``target`` must be a module-level function."""
    ctx = mp.start_processes(_rank, args=(n, str(tmp_path), target, args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n} gloo ranks still running after "
                                   f"{RUN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]
