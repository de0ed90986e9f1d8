"""The port's checkpoints and restartable loop (``repro_torch.checkpoint``,
``repro_torch.train.fault_tolerance``): the cases of
``tests/test_checkpoint.py`` and of the non-elastic half of
``tests/test_fault_tolerance.py`` on the port, then across the packages:
a JAX checkpoint with a bf16 leaf restores in the port bit for bit, the
port writes the same state as byte-identical leaf files and the same
manifest, JAX restores the port's checkpoint bit for bit, and a training
run that restarts after an injected failure replays the uninterrupted
run's losses and parameters exactly."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro_torch import tree
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import (StragglerWatch, TransientError,
                                               run_restartable)
from repro_torch.train.trainer import (TrainStepConfig, init_train_state,
                                       make_train_step)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": torch.ones(8, 8),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(t):
    return tree.map(torch.zeros_like, t)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py's cases
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 3, t, extra={"note": "x"})
    restored, extra = restore_checkpoint(d, _zeros_like(t))
    assert extra["step"] == 3 and extra["note"] == "x"
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_pointer_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _tree(s), keep=2)
    assert latest_step(d) == 5
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]


def test_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(d, {"just_one": torch.zeros(2)})


def test_async_manager(tmp_path):
    """The snapshot is taken when ``save_async`` returns: training on in
    place afterwards does not reach the file."""
    d = str(tmp_path)
    mgr = CheckpointManager(d)
    t = _tree()
    want = t["params"]["w"].clone()
    mgr.save_async(10, t)
    t["params"]["w"].add_(1.0)
    mgr.wait()
    assert latest_step(d) == 10
    restored, _ = restore_checkpoint(d, _zeros_like(t))
    assert torch.equal(restored["params"]["w"], want)


def test_restore_to_device_and_grad(tmp_path):
    """``device`` takes the place of JAX's shardings; without it a leaf
    goes where the like-tree's does, with its ``requires_grad``."""
    d = str(tmp_path)
    t = _tree()
    save_checkpoint(d, 1, t)
    restored, _ = restore_checkpoint(d, t, device="cpu")
    assert all(x.device.type == "cpu" for x in tree.leaves(restored))
    like = _zeros_like(t)
    like["params"]["w"].requires_grad_(True)
    restored, _ = restore_checkpoint(d, like, step=1)
    assert restored["params"]["w"].requires_grad
    assert restored["params"]["w"].is_leaf
    assert not restored["params"]["b"].requires_grad


def test_tmp_dir_never_visible_as_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) == 1


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_state():
    """A train-state-shaped tree with bf16, f32 and int32 leaves, its keys
    out of sorted order."""
    k = jax.random.PRNGKey(3)
    return {"params": {"w": jax.random.normal(k, (8, 4), jnp.bfloat16),
                       "b": jnp.arange(4, dtype=jnp.bfloat16) / 3,
                       "layers": {"z": jnp.ones((2, 3)),
                                  "a": jax.random.normal(k, (5,))}},
            "opt": {"v": jnp.full((3,), 0.25), "step": jnp.int32(11),
                    "m": jnp.zeros((2, 2))}}


def _as_torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "fV" else a


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    state = _jax_state()
    JCK.save_checkpoint(str(tmp_path), 4, state, extra={"by": "jax"})
    like = tree.map(lambda x: torch.zeros(()),
                    jax.tree.map(lambda x: 0, state))
    restored, extra = restore_checkpoint(str(tmp_path), like)
    assert extra == {"by": "jax", "step": 4}
    for got, want in zip(tree.leaves(restored), jax.tree.leaves(state)):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_port_checkpoint_files_equal_jax_bytes(tmp_path):
    state = _jax_state()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save_checkpoint(jdir, 2, state)
    save_checkpoint(tdir, 2, tree.map(_as_torch,
                                      jax.tree.map(np.asarray, state)))
    jbase, tbase = (os.path.join(x, "step_00000002") for x in (jdir, tdir))
    with open(os.path.join(jbase, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tbase, "manifest.json")) as f:
        tman = json.load(f)
    assert tman == jman
    for rec in jman["leaves"]:
        with open(os.path.join(jbase, rec["file"]), "rb") as f:
            want = f.read()
        with open(os.path.join(tbase, rec["file"]), "rb") as f:
            assert f.read() == want, rec
    with open(os.path.join(tdir, "LATEST")) as f:
        assert f.read() == "step_00000002"


def test_jax_restores_the_port_checkpoint(tmp_path):
    state = _jax_state()
    save_checkpoint(str(tmp_path), 6,
                    tree.map(_as_torch, jax.tree.map(np.asarray, state)))
    assert JCK.latest_step(str(tmp_path)) == 6
    restored, extra = JCK.restore_checkpoint(str(tmp_path), state)
    assert extra["step"] == 6
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's non-elastic cases
# ---------------------------------------------------------------------------

def test_straggler_flags_outlier():
    w = StragglerWatch(k=5.0)
    for _ in range(20):
        assert not w.observe(1.0 + np.random.default_rng(0).normal() * 1e-3)
    assert w.observe(10.0)


def test_straggler_ignores_noise():
    w = StragglerWatch(k=8.0)
    rng = np.random.default_rng(1)
    flags = [w.observe(1.0 + rng.normal() * 0.01) for _ in range(100)]
    assert sum(flags) <= 3


def test_straggler_hosts():
    w = StragglerWatch(k=3.0)
    hosts = {f"h{i}": 1.0 for i in range(16)}
    hosts["h7"] = 9.0
    assert w.observe_hosts(hosts) == ["h7"]


def _toy_setup():
    """Tiny quadratic 'training': the loss falls as x shrinks."""

    def init_state():
        return {"params": {"x": torch.ones(())},
                "opt": {"step": torch.tensor(0, dtype=torch.int32)}}

    def train_step(state, batch):
        x = state["params"]["x"]
        x = x - 0.05 * (2 * x * batch)
        s = {"params": {"x": x},
             "opt": {"step": state["opt"]["step"] + 1}}
        return s, {"loss": x * x}

    def batches(step):
        return torch.tensor(1.0)

    return init_state, train_step, batches


def test_run_completes_without_failures(tmp_path):
    init_state, train_step, batches = _toy_setup()
    rep = run_restartable(train_step=train_step, init_state=init_state,
                          batches=batches, ckpt_dir=str(tmp_path),
                          total_steps=20, ckpt_every=5)
    assert rep.steps_done == 20 and rep.restarts == 0
    assert float(rep.final_metrics["loss"]) < 0.2


def test_restart_on_transient_failure(tmp_path):
    init_state, train_step, batches = _toy_setup()
    tripped = {"done": False}

    def injector(step):
        if step == 12 and not tripped["done"]:
            tripped["done"] = True
            raise TransientError("simulated node loss at step 12")

    rep = run_restartable(train_step=train_step, init_state=init_state,
                          batches=batches, ckpt_dir=str(tmp_path),
                          total_steps=20, ckpt_every=5,
                          fail_injector=injector)
    assert rep.restarts == 1
    assert rep.steps_done == 20


def test_too_many_restarts_raises(tmp_path):
    init_state, train_step, batches = _toy_setup()

    def always_fail(step):
        if step >= 2:
            raise TransientError("hard down")

    with pytest.raises(TransientError):
        run_restartable(train_step=train_step, init_state=init_state,
                        batches=batches, ckpt_dir=str(tmp_path),
                        total_steps=20, ckpt_every=1, max_restarts=2,
                        fail_injector=always_fail)


def test_resume_is_deterministic(tmp_path):
    init_state, train_step, batches = _toy_setup()
    rep_clean = run_restartable(train_step=train_step,
                                init_state=init_state, batches=batches,
                                ckpt_dir=str(tmp_path / "a"),
                                total_steps=15, ckpt_every=3)
    tripped = {}

    def injector(step):
        if step == 7 and not tripped:
            tripped["x"] = 1
            raise TransientError("boom")

    rep_fail = run_restartable(train_step=train_step,
                               init_state=init_state, batches=batches,
                               ckpt_dir=str(tmp_path / "b"),
                               total_steps=15, ckpt_every=3,
                               fail_injector=injector)
    np.testing.assert_allclose(float(rep_clean.final_metrics["loss"]),
                               float(rep_fail.final_metrics["loss"]),
                               rtol=1e-6)


def test_train_lm_resume_replays_bit_for_bit(tmp_path):
    """A real train step (minicpm's family at a tiny width, the WSD
    schedule, the port's data): 12 steps with a checkpoint every 4 and a
    failure injected at step 6 replay the uninterrupted run's per-step
    losses and final parameters and moments exactly."""
    import dataclasses
    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True),
                              num_layers=2, vocab_size=128)
    model = build_model(cfg, device="cpu")
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-2), schedule_warmup=2,
                         schedule_total_steps=12)
    step_fn = make_train_step(model, ts)

    def run(ckpt_dir, fail_at=None):
        losses, current, tripped = {}, {}, {}

        def batches(step):
            current["step"] = step
            return batch_for_step(cfg, step, 2, 8, device="cpu")

        def train_step(state, batch):
            state, metrics = step_fn(state, batch)
            losses[current["step"]] = float(metrics["loss"])
            current["state"] = state
            return state, metrics

        def injector(step):
            if step == fail_at and not tripped:
                tripped["x"] = 1
                raise TransientError("simulated node loss")

        rep = run_restartable(
            train_step=train_step,
            init_state=lambda: init_train_state(model, model.init(0), ts),
            batches=batches, ckpt_dir=ckpt_dir, total_steps=12,
            ckpt_every=4, fail_injector=injector)
        return rep, losses, current["state"]

    rep_a, losses_a, state_a = run(str(tmp_path / "a"))
    rep_b, losses_b, state_b = run(str(tmp_path / "b"), fail_at=6)
    assert rep_a.restarts == 0 and rep_b.restarts == 1
    assert rep_b.steps_done == 12 and losses_b == losses_a
    for a, b in zip(tree.leaves(state_a), tree.leaves(state_b)):
        assert torch.equal(a.detach(), b.detach())
