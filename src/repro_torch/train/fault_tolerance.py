"""Fault tolerance: the restartable loop and the straggler watch, the port
of ``repro.train.fault_tolerance``.

* CHECKPOINT/RESTART: ``run_restartable`` wraps the train loop; a step
  that raises ``TransientError`` restores the latest checkpoint and
  replays.  The data pipeline is a pure function of the step and every
  op of the train step is deterministic, so replayed steps give the same
  bits.
* STRAGGLER MITIGATION: ``StragglerWatch`` keeps a robust running
  estimate of step time (median + MAD) and flags steps or hosts that run
  k·MAD over it.

* ELASTIC SCALING: ``elastic_remesh`` re-carves the mesh for a new
  healthy device count and ``reshard_state`` re-places a state tree onto
  it (DTensor ``redistribute`` within a mesh, ``distribute_tensor`` of the
  whole leaf onto another); the checkpoint path works identically through
  ``restore_checkpoint(shardings=...)``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint)
from repro_torch.core.dtensor import is_dtensor
from repro_torch.core.policies import NamedSharding, placements


@dataclasses.dataclass
class StragglerWatch:
    """Flags steps (or, with per-host timings, hosts) that run k·MAD over
    the median step time."""

    k: float = 5.0
    window: int = 50
    _times: list[float] = dataclasses.field(default_factory=list)

    def observe(self, seconds: float) -> bool:
        """Record a step duration; True if it is a straggler event."""
        history = self._times[-self.window:]
        self._times.append(seconds)
        if len(history) < 10:
            return False
        med = statistics.median(history)
        mad = statistics.median([abs(t - med) for t in history]) or 1e-9
        return seconds > med + self.k * mad

    def observe_hosts(self, per_host_seconds: dict[str, float]
                      ) -> list[str]:
        """Multi-host variant: which hosts straggle this step."""
        vals = list(per_host_seconds.values())
        med = statistics.median(vals)
        mad = statistics.median([abs(v - med) for v in vals]) or 1e-9
        return [h for h, v in per_host_seconds.items()
                if v > med + self.k * mad]


class TransientError(RuntimeError):
    """A failure worth restarting from checkpoint (preemption, link flap)."""


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    straggler_events: int
    final_metrics: dict | None


def _wait_for(x: Any) -> None:
    """Block until the device has computed ``x`` (JAX's
    ``block_until_ready``)."""
    if is_dtensor(x):
        x = x.to_local()
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def run_restartable(*,
                    train_step: Callable[[Any, Any], tuple[Any, dict]],
                    init_state: Callable[[], Any],
                    batches: Callable[[int], Any],
                    ckpt_dir: str,
                    total_steps: int,
                    ckpt_every: int = 50,
                    max_restarts: int = 3,
                    device=None,
                    state_shardings: Any | None = None,
                    fail_injector: Callable[[int], None] | None = None
                    ) -> RunReport:
    """Checkpointed training loop with restart-on-transient-failure.

    ``fail_injector(step)`` (tests) may raise TransientError to simulate a
    node loss; the loop restores from the latest checkpoint and replays.
    ``ckpt_every <= 0`` writes no checkpoint (JAX's loop divides by it): a
    restart then replays from ``init_state()``, for a state too large to
    write out.
    A restored state's leaves go to ``device``, or, when that is None, to
    the devices of ``init_state()``'s; ``state_shardings`` places them as
    ``restore_checkpoint``'s ``shardings`` does (without it a DTensor leaf
    of ``init_state()`` keeps its mesh and placements)."""
    mgr = CheckpointManager(ckpt_dir)
    watch = StragglerWatch()
    restarts = 0
    stragglers = 0
    metrics: dict | None = None

    def fresh_or_restored():
        state = init_state()
        start = 0
        last = latest_step(ckpt_dir)
        if last is not None:
            state, extra = restore_checkpoint(ckpt_dir, state, device=device,
                                              shardings=state_shardings)
            start = extra["step"] + 1
        return state, start

    state, step = fresh_or_restored()
    while step < total_steps:
        try:
            t0 = time.monotonic()
            if fail_injector is not None:
                fail_injector(step)
            state, metrics = train_step(state, batches(step))
            _wait_for(metrics["loss"])
            if watch.observe(time.monotonic() - t0):
                stragglers += 1
            if ckpt_every > 0 and (step % ckpt_every == 0
                                   or step == total_steps - 1):
                mgr.save_async(step, state, extra={})
            step += 1
        except TransientError:
            restarts += 1
            if restarts > max_restarts:
                raise
            mgr.wait()
            state, step = fresh_or_restored()
    mgr.wait()
    return RunReport(steps_done=step, restarts=restarts,
                     straggler_events=stragglers, final_metrics=metrics)


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------

def elastic_remesh(n_devices: int, *, model_parallel: int,
                   device_type: str | None = None):
    """Best (data, model) mesh for a surviving device count: keep the model
    axis (weights layout) and shrink data parallelism.  A ``DeviceMesh``
    over the default process group, whose world size must be
    ``n_devices``; on ``cuda`` unless ``device_type`` says otherwise."""
    from repro_torch.launch.mesh import make_mesh
    if n_devices % model_parallel:
        # degrade model parallelism to the largest divisor that fits
        while model_parallel > 1 and n_devices % model_parallel:
            model_parallel //= 2
    data = n_devices // model_parallel
    return make_mesh((data, model_parallel), ("data", "model"),
                     device_type=device_type)


def reshard_state(state: Any, spec_tree: Any, mesh) -> Any:
    """Each leaf placed by its spec on ``mesh``: a DTensor already on that
    mesh is redistributed; any other leaf (a plain tensor, or a DTensor of
    another mesh, gathered whole) is distributed from its whole value."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, s):
        want = NamedSharding(mesh, placements(s, mesh))
        if is_dtensor(x):
            if x.device_mesh == mesh:
                return x.redistribute(mesh, want.placements)
            x = x.full_tensor()
        return distribute_tensor(x.to(mesh.device_type), mesh,
                                 want.placements)
    return tree.map(put, state, spec_tree)
