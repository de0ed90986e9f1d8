"""End-to-end training through the PyTorch/CUDA port: data pipeline →
train loop → checkpoint/restart → metrics, the counterpart of
``examples/train_lm.py``.

The default trains a ~10M-parameter LM (minicpm-2b's family and WSD
schedule cut to 4 layers of width 256, vocabulary 8192, float32) for 30
steps; ``--full`` trains the ~100M-parameter config for ``--steps``
steps.  Batches are ``batch_for_step``'s (a pure function of the step),
the loop is ``run_restartable`` (a checkpoint every 10 steps), and the
loss must fall.  On the card every attention's forward runs through the
flash-attention kernel.  A directory that already holds checkpoints
resumes from the latest one.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 30] [--full]
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.models import build_model
from repro_torch.models.api import param_count
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import run_restartable
from repro_torch.train.trainer import (TrainStepConfig, init_train_state,
                                       make_train_step)


def model_config(full: bool):
    base = get_config("minicpm-2b")          # WSD schedule showcase
    if full:
        # ~100M params: 12L × d512 × ff2048, 32k vocab
        return dataclasses.replace(
            base, name="lm-100m", num_layers=12, d_model=512, num_heads=8,
            num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=32768,
            dtype="float32", param_dtype="float32")
    return dataclasses.replace(
        base, name="lm-10m", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=1024, vocab_size=8192,
        dtype="float32", param_dtype="float32")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    return ap


def train(args: argparse.Namespace, fail_injector=None) -> dict:
    """Trains as ``main`` does; ``fail_injector(step)`` may raise
    ``TransientError``.  Returns ``losses`` (step → loss, the last run of
    each step), ``history`` ((step, loss) in the order run), the final
    ``state`` and the ``report``."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_config(args.full)
    model = build_model(cfg, device=device)
    ts = TrainStepConfig(opt=AdamWConfig(lr=3e-4),
                         schedule_warmup=max(2, args.steps // 10),
                         schedule_total_steps=args.steps,
                         microbatch=0, remat=False)
    step_fn = make_train_step(model, ts)

    def init_state():
        lm = model.init(0)
        print(f"model {cfg.name}: {param_count(lm.params) / 1e6:.1f}M "
              f"params, schedule={cfg.lr_schedule}, on {device}")
        return init_train_state(model, lm, ts)

    t0 = time.time()
    losses: dict[int, float] = {}
    history: list[tuple[int, float]] = []
    current: dict = {}

    def batches(step: int):
        current["step"] = step
        return batch_for_step(cfg, step, args.batch, args.seq, device=device)

    def step_and_log(state, batch):
        state, metrics = step_fn(state, batch)
        current["state"] = state
        step, loss = current["step"], float(metrics["loss"])
        losses[step] = loss
        history.append((step, loss))
        k = len(history)
        if k % 5 == 0 or k == 1:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / k:.2f}s/step)")
        return state, metrics

    report = run_restartable(
        train_step=step_and_log,
        init_state=init_state,
        batches=batches,
        ckpt_dir=args.ckpt_dir,
        total_steps=args.steps,
        ckpt_every=max(10, args.steps // 3),
        fail_injector=fail_injector,
    )
    return {"losses": losses, "history": history,
            "state": current.get("state"), "report": report}


def main(argv: list[str] | None = None) -> dict:
    out = train(parser().parse_args(argv))
    losses, report = out["losses"], out["report"]
    if not losses:
        raise RuntimeError("no step ran: the checkpoint directory already "
                           "holds a finished run")
    first, last = losses[min(losses)], losses[max(losses)]
    print(f"\ndone: {report.steps_done} steps, {report.restarts} restarts, "
          f"loss {first:.3f} → {last:.3f}")
    if not last < first:
        raise RuntimeError("training must reduce loss")
    return out


if __name__ == "__main__":
    main()
