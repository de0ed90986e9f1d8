"""The port's launcher (``repro_torch.launch.train``) and dry run
(``repro_torch.launch.dryrun``) on the CPU.

Each runs in a process of its own, since both make a default process group
(a one-rank gloo group, a fake one of 8 ranks) and no pytest worker may
hold one.  The launcher trains minicpm-2b-smoke on a 1×1 mesh of DTensors
across a forced restart; every step's loss, the replayed one too, must
equal bit for bit the loss of the plain-tensor trainer (``make_train_step``
under ``run_restartable``, as ``examples/train_lm_torch.py`` drives it) at
the same seed and config (the failure is raised by the caller's
``step_context``).  The dry run runs a dense cell on a fake 2×4
mesh: it exits 0, reports per-device argument bytes equal to the sum of
the local shard shapes that the policy's specs give, nonzero FLOPs, and
nothing computed replicated (the vocab-sharded table takes the masked
lookup); a MoE cell's record, under either policy, names nothing either
(the expert-parallel FFN); deepseek-moe-16b's train cell at 16-way model
parallelism (one head of 128 a shard), cut to 2 layers, takes its step;
a cell that raises makes it exit 1.  The new modules import no JAX.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.policies import ShapeMesh, get_policy
from repro_torch.data.pipeline import make_batch_specs

ROOT = Path(__file__).resolve().parents[1]
STEPS, FAIL_AT, CKPT_EVERY = 5, 3, 2
BATCH, SEQ = 4, 32


def _run(code: str, *argv: str, check: bool = True,
         timeout: int = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if check:
        assert out.returncode == 0, out.stderr[-4000:]
    return out


# argv: the step to fail once at (-1: none), then the launcher's flags
LAUNCH = """
import contextlib, json, sys, torch
torch.set_num_threads(1)
from repro_torch.core.dtensor import is_dtensor
from repro_torch import tree
from repro_torch.launch import train
from repro_torch.train.fault_tolerance import TransientError
fail_at, failed = int(sys.argv[1]), []

@contextlib.contextmanager
def fail_once(step):
    if step == fail_at and not failed:
        failed.append(step)
        raise TransientError(f"injected at step {step}")
    yield

out = train.run(train.parser().parse_args(sys.argv[2:]),
                step_context=fail_once)
leaves = tree.leaves(out["state"]["params"]) + tree.leaves(out["state"]["opt"]["m"])
print(json.dumps({"history": out["history"],
                  "dtensors": all(is_dtensor(x) for x in leaves),
                  "restarts": out["report"].restarts}))
"""


def test_launcher_matches_plain_trainer_across_a_restart(tmp_path):
    torch.set_num_threads(1)
    argv = ["--arch", "minicpm-2b", "--smoke", "--steps", str(STEPS),
            "--global-batch", str(BATCH), "--seq", str(SEQ), "--mesh", "1x1",
            "--policy", "fused_seq", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "launch"), "--ckpt-every", str(CKPT_EVERY)]
    got = json.loads(_run(LAUNCH, str(FAIL_AT), *argv).stdout.strip()
                     .splitlines()[-1])
    assert got["dtensors"] and got["restarts"] == 1
    steps = [s for s, _, _ in got["history"]]
    # a checkpoint at step 2 (every 2nd): the failure at 3 replays from 3
    assert steps == [0, 1, 2, 3, 4], steps

    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import parser, train_config
    from repro_torch.models import build_model
    from repro_torch.train.fault_tolerance import run_restartable
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = get_config("minicpm-2b", smoke=True)
    model = build_model(cfg, device="cpu")
    ts = train_config(parser().parse_args(argv))
    step_fn = make_train_step(model, ts)
    plain: list[float] = []

    def step_and_log(state, batch):
        state, metrics = step_fn(state, batch)
        plain.append(float(metrics["loss"]))
        return state, metrics

    run_restartable(
        train_step=step_and_log,
        init_state=lambda: init_train_state(model, model.init(0), ts),
        batches=lambda s: batch_for_step(cfg, s, BATCH, SEQ, device="cpu"),
        ckpt_dir=str(tmp_path / "plain"), total_steps=STEPS,
        ckpt_every=CKPT_EVERY)
    assert [loss for _, loss, _ in got["history"]] == plain
    assert all(math.isfinite(x) for x in plain)


def _local_bytes(specs, shapes, sizes) -> int:
    total = 0
    for s, x in zip(tree.leaves(specs), tree.leaves(shapes)):
        dims = list(x.shape)
        for d, part in enumerate(s):
            names = (part,) if isinstance(part, str) else (part or ())
            for n in names:
                dims[d] //= sizes[n]
        total += math.prod(dims) * x.element_size()
    return total


DRYRUN = """
import sys
from repro_torch.launch import dryrun
dryrun.main(sys.argv[1:])
"""


def test_dryrun_dense_cell_on_a_fake_mesh(tmp_path):
    out_json = tmp_path / "dry.json"
    _run(DRYRUN, "--mesh", "2x4", "--cells", "qwen3-32b@prefill_32k",
         "--policy", "layerwise_tp", "--smoke", "--out", str(out_json))
    (rec,) = json.loads(out_json.read_text())
    assert rec["status"] == "ok" and rec["num_devices"] == 8
    cfg = get_config("qwen3-32b", smoke=True)
    mesh = ShapeMesh((2, 4), ("data", "model"))
    pol = get_policy("layerwise_tp", mesh, cfg)
    from repro_torch.models import build_model
    params = build_model(cfg, device="meta").init(0).params
    batch = make_batch_specs(cfg, 32, 32768)
    want = _local_bytes(pol.param_spec(params), params, mesh.shape) \
        + _local_bytes(pol.batch_spec(batch), batch, mesh.shape)
    assert rec["bytes_per_device"]["argument"] == want
    assert rec["flops_per_device"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["hbm_bytes_per_device"].startswith("unavailable: ")
    # the vocab-sharded table takes the masked lookup, gathered nowhere
    assert rec["computed_replicated"] == []


@pytest.mark.parametrize("policy", ["fused_seq", "layerwise_tp"])
def test_dryrun_marks_the_moe_ffn_as_computed_replicated(tmp_path, policy):
    """The MoE FFN runs expert-parallel on the local shards under both
    policies, so the record marks nothing as computed replicated."""
    out_json = tmp_path / "dry.json"
    _run(DRYRUN, "--mesh", "2x4", "--cells", "deepseek-moe-16b@prefill_32k",
         "--policy", policy, "--smoke", "--out", str(out_json))
    (rec,) = json.loads(out_json.read_text())
    assert rec["status"] == "ok"
    assert rec["computed_replicated"] == []


def test_dryrun_trains_deepseek_at_16_way_model_parallelism(tmp_path):
    """deepseek-moe-16b's train cell under ``layerwise_tp`` on a fake 1×16
    mesh, cut to its dense layer and one MoE layer: each shard holds one
    K head of 128, whose gradient leaves the attention backward
    transposed; the step must take its backward through the head reshape
    and the projection (it raised in ``aten.view``)."""
    out_json = tmp_path / "dry.json"
    _run(DRYRUN, "--mesh", "1x16", "--cells", "deepseek-moe-16b@train_4k",
         "--policy", "layerwise_tp", "--layers", "2", "--out",
         str(out_json))
    (rec,) = json.loads(out_json.read_text())
    assert rec["status"] == "ok", rec
    assert rec["flops_per_device"] > 0
    assert rec["computed_replicated"] == []


STUBBED = """
import sys
from repro_torch.launch import dryrun

def broken(*args, **kwargs):
    raise RuntimeError("stubbed failure")

dryrun.run_cell = broken
dryrun.main(sys.argv[1:])
"""


def test_dryrun_exits_1_when_a_cell_fails(tmp_path):
    out_json = tmp_path / "dry.json"
    res = _run(STUBBED, "--mesh", "2x4", "--cells", "qwen3-32b@prefill_32k",
               "--smoke", "--out", str(out_json), check=False)
    assert res.returncode == 1, res.stderr[-2000:]
    (rec,) = json.loads(out_json.read_text())
    assert rec["status"] == "fail" and "stubbed failure" in rec["error"]


def test_dryrun_skips_what_the_assignment_skips(tmp_path):
    out_json = tmp_path / "dry.json"
    _run(DRYRUN, "--mesh", "2x4", "--cells", "qwen3-32b@long_500k",
         "--out", str(out_json))
    (rec,) = json.loads(out_json.read_text())
    assert rec["status"] == "skip"


def test_launch_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.comm, repro_torch.launch.cells, "
            "repro_torch.launch.mesh, repro_torch.core.policies, "
            "repro_torch.core.hints, repro_torch.core.dtensor; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
            "assert not bad, bad")
    _run(code)


def test_launcher_refuses_without_a_card(tmp_path):
    """No fallback: without ``--device cpu`` the launcher needs CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(LAUNCH, "-1", "--arch", "minicpm-2b", "--smoke", "--steps",
               "1", "--ckpt-dir", str(tmp_path), check=False)
    assert res.returncode != 0
    assert "CUDA device" in res.stderr
