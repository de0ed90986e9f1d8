"""Production training launcher, the port of ``repro.launch.train``.

Maps (architecture, policy, mesh) to the sharded restartable train loop:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 4 --mesh 1x1 --policy fused_seq

The state's leaves are DTensors on a ``data``×``model`` ``DeviceMesh``:
parameters placed by the policy's ``param_spec``, the AdamW moments by
``state_spec``'s ZeRO-1 specs, each batch by ``batch_spec``.  The step is
``make_train_step``'s, whose kernels take the DTensor route of
``kernels/ops.py``; every run is checkpointed and restartable, and
stragglers are logged by the watch.

Process group: under a launcher that sets ``WORLD_SIZE`` (``torchrun``)
this joins that group (``env://``); otherwise it makes a one-rank group on
an in-memory store, which needs no network: NCCL on the card, gloo with
``--device cpu``.  A caller that has initialised a group keeps it.  The
mesh's size must be the world size.  Every rank draws the whole state from
seed 0 and ``Policy.shard`` keeps rank 0's copy, as every rank computes
every batch (``batch_for_step``).  It runs on the card; ``--device cpu``
asks for the plain path on the CPU, and a missing card raises.
``--ckpt-every 0`` writes no checkpoint (a restart then starts over from
the seed).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device, tree
from repro_torch.configs import get_config
from repro_torch.core.policies import get_policy, placements
from repro_torch.data.pipeline import batch_for_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.api import param_count
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import StragglerWatch, run_restartable
from repro_torch.train.trainer import (TrainStepConfig, init_train_state,
                                       make_train_step, state_spec)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data×model mesh, e.g. 16x16")
    ap.add_argument("--policy", default="fused_seq",
                    choices=["fused_seq", "layerwise_tp",
                             "fused_seq_zero3"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    return ap


def train_config(args: argparse.Namespace) -> TrainStepConfig:
    return TrainStepConfig(opt=AdamWConfig(lr=args.lr),
                           microbatch=args.microbatch, remat=args.remat,
                           compress_grads=args.compress_grads,
                           schedule_total_steps=args.steps,
                           schedule_warmup=max(2, args.steps // 20))


@contextlib.contextmanager
def process_group(device_type: str):
    """The default process group for this run: the caller's if one is
    initialised, ``env://`` under a launcher that sets ``WORLD_SIZE``,
    else one rank on an in-memory store.  Destroys what it made."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = datetime.timedelta(minutes=10)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_batch(policy, batch: dict) -> dict:
    """The batch as DTensors placed by ``policy.batch_spec``."""
    from torch.distributed.tensor import distribute_tensor
    spec = policy.batch_spec(batch)
    return tree.map(lambda x, s: distribute_tensor(
        x, policy.mesh, placements(s, policy.mesh)), batch, spec)


def shard_state(policy, state: dict) -> dict:
    """The train state's leaves as DTensors: parameters by the policy's
    specs, the moments (and error feedback) by ZeRO-1's; ``step`` stays a
    host tensor.  One subtree at a time, so the whole plain state is never
    held twice."""
    sspec = state_spec(policy, state["params"])
    state["params"] = policy.shard(state["params"], sspec["params"])
    for k in ("m", "v"):
        state["opt"][k] = policy.shard(state["opt"][k], sspec["opt"][k])
    if "ef" in state:
        state["ef"] = policy.shard(state["ef"], sspec["opt"]["m"])
    return state


def run(args: argparse.Namespace, step_context=None, layers: int = 0
        ) -> dict:
    """Trains as ``main`` does.  Returns ``losses`` (step → loss, the last
    run of each step), ``history`` ((step, loss, seconds) in the order
    run: a replayed step appears twice), the final ``state``, ``ts``,
    ``model``, ``policy`` and the ``report``.  Within a caller's process
    group the returned DTensors stay usable.  ``step_context(step)``, if
    given, returns a context manager entered around each step (a caller's
    counters; a ``TransientError`` it raises restarts the run from the
    latest checkpoint).  ``layers`` cuts the config to its first N layers
    at full width (0: all)."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    d, m = (int(v) for v in args.mesh.split("x"))
    with process_group(device.type):
        mesh = make_mesh((d, m), ("data", "model"), device_type=device.type)
        cfg = get_config(args.arch, smoke=args.smoke)
        if layers:
            cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{layers}-layers",
                                      num_layers=layers)
        model = build_model(cfg, device=device)
        policy = get_policy(args.policy, mesh, cfg)
        ts = train_config(args)
        step_fn = make_train_step(model, ts)
        watch = StragglerWatch()

        def init_state():
            lm = model.init(0)
            print(f"{cfg.name}: {param_count(lm.params) / 1e6:.1f}M params "
                  f"on {mesh.size()} devices, policy={policy.name}")
            return shard_state(policy, init_train_state(model, lm, ts))

        t0 = time.time()
        count = [0]
        current: dict = {}
        losses: dict[int, float] = {}
        history: list[tuple[int, float, float]] = []

        def batches(step: int) -> dict:
            current["step"] = step
            return shard_batch(policy, batch_for_step(
                cfg, step, args.global_batch, args.seq, device=device))

        def step_and_log(state, batch):
            around = step_context(current["step"]) if step_context \
                else contextlib.nullcontext()
            t_step = time.perf_counter()
            with around:
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])  # synchronises the device
            secs = time.perf_counter() - t_step
            current["state"] = state
            count[0] += 1
            k = count[0]
            losses[current["step"]] = loss
            history.append((current["step"], loss, secs))
            dt = time.time() - t0
            if watch.observe(dt / k):
                print(f"  [straggler-watch] slow step {k}")
            if k % 10 == 0 or k == 1:
                print(f"step {k:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt / k:.2f}s/step")
            return state, metrics

        report = run_restartable(
            train_step=step_and_log,
            init_state=init_state,
            batches=batches,
            ckpt_dir=args.ckpt_dir,
            total_steps=args.steps,
            ckpt_every=args.ckpt_every)
        final = report.final_metrics
        print(f"finished {report.steps_done} steps "
              f"({report.restarts} restarts, "
              f"{report.straggler_events} straggler events); final loss "
              + (f"{float(final['loss']):.4f}" if final else "n/a"))
        return {"losses": losses, "history": history,
                "state": current.get("state"), "ts": ts, "model": model,
                "policy": policy, "report": report}


def main(argv: list[str] | None = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
