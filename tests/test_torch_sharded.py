"""The port's sharded train step on CPU ``gloo`` ranks, against the same step
in one process.

Four ranks on a 2×2 ``data``×``model`` mesh (``tests/gloo_ranks.py``, one
intra-op thread a rank) take one float32 train step from the seed-0 state
of qwen3-32b-smoke under each of the three policies with the policy's
sharding hints on, and of zamba2-2.7b-smoke and xlstm-1.3b-smoke (the
scans' DTensor route), deepseek-moe-16b-smoke under ``fused_seq`` and
``layerwise_tp`` and granite-moe-1b-a400m-smoke under ``fused_seq`` (the
expert-parallel MoE FFN, and under ``layerwise_tp`` the masked lookup in
the vocab-sharded table); each must match the unsharded step, with the f32
twins' bounds: the loss within 1e-5 relative, each gradient leaf within
1e-4·max|g|, each AdamW moment leaf (m and v, which are linear in g and
g²) within 1e-4 of its max, each updated parameter within 2·lr + 1e-6.
The MoE cases hold the global slot positions only where the unsharded
step drops assignments, so that step must drop some; each rank must have
taken the expert-parallel route once per MoE layer and the masked lookup
once per step where the table is vocab-sharded.  The masked lookup alone,
on a 1×4 mesh (the table in 4 vocab shards), must give the unsharded
``F.embedding``'s values and table gradient bit for bit.  A microbatched
``fused_seq`` step (a microbatch of 2 rows, a multiple of the data size,
split shard by shard) must match the unsharded microbatched step; a
microbatch that does not split every rank's rows raises, as does one that
does not split the batch.  The same ranks count the collectives of the
qwen3 step under ``layerwise_tp`` and ``fused_seq`` (``launch/comm.py``),
held as JAX's ``test_policies_lower_both_meshes`` holds its HLO counts,
and printed beside JAX's (a subprocess with 4 host devices).

Elastic re-meshing, as ``tests/test_elastic.py`` but against unsharded
results (that JAX test fails on the reference): the 2×2 ``layerwise_tp``
state after its step is saved, restored on 2 ranks onto
``elastic_remesh(2, model_parallel=4)`` (a 1×2 mesh), and must hold the
saved values bit for bit, its files byte for byte those of the same state
saved unsharded; ``reshard_state`` re-places them under another policy
without changing a bit; the next step must match the unsharded step from
that state.  The launcher itself runs on the 4 ranks across a restart from
a checkpoint (raised by its ``step_context``).  The module imports no JAX
at top level: every rank imports it.
"""

import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from gloo_ranks import run_ranks

from repro_torch import tree

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 16
LR = 3e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
UPDATE_ATOL = 2 * LR + 1e-6
CASES = [("qwen3-32b", "layerwise_tp"), ("qwen3-32b", "fused_seq"),
         ("qwen3-32b", "fused_seq_zero3"), ("zamba2-2.7b", "fused_seq"),
         ("xlstm-1.3b", "fused_seq"), ("deepseek-moe-16b", "fused_seq"),
         ("deepseek-moe-16b", "layerwise_tp"),
         ("granite-moe-1b-a400m", "fused_seq")]
COUNTED = ("layerwise_tp", "fused_seq")
# a microbatched step: 2 rows a microbatch, one from each data shard
MICRO_CASE, MICRO = ("qwen3-32b", "fused_seq"), 2
# the launcher on the 4 ranks: qwen3-32b-smoke, a checkpoint every step and
# a forced restart at step 2 (its async saves and the barrier on 4 ranks)
LAUNCH_ARGS = ["--arch", "qwen3-32b", "--smoke", "--steps", "3", "--mesh",
               "2x2", "--policy", "layerwise_tp", "--global-batch",
               str(BATCH), "--seq", str(SEQ), "--device", "cpu",
               "--ckpt-every", "1"]
LAUNCH_FAIL_AT = 2


def _setup(arch: str, microbatch: int = 0):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainStepConfig
    cfg = get_config(arch, smoke=True)
    ts = TrainStepConfig(opt=AdamWConfig(lr=LR), schedule_warmup=2,
                         schedule_total_steps=100, microbatch=microbatch)
    return cfg, build_model(cfg, device="cpu"), ts


def _full(x):
    """A copy of ``x``'s whole value (a replicated DTensor's ``full_tensor``
    is its local tensor, which the next step updates in place)."""
    from repro_torch.core.dtensor import is_dtensor
    x = x.detach()
    return (x.full_tensor() if is_dtensor(x) else x).clone()


def _step(model, ts, state, batch, counter=None) -> dict:
    """One train step in place, as ``make_train_step`` takes it (its
    gradients, then AdamW at the schedule's factor): the loss, the
    gradients, the new moments and the new parameters, gathered whole."""
    import contextlib

    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.schedule import make_schedule
    from repro_torch.train.trainer import make_grad_fn
    schedule = make_schedule(model.cfg.lr_schedule,
                             warmup=ts.schedule_warmup,
                             total=ts.schedule_total_steps)
    with counter if counter is not None else contextlib.nullcontext():
        loss, _, grads = make_grad_fn(model, ts)(state["params"], batch)
        adamw_update(ts.opt, state["params"], grads, state["opt"],
                     schedule(state["opt"]["step"] + 1))
    return {"loss": float(loss),
            "grads": [_full(g) for g in tree.leaves(grads)],
            "m": [_full(x) for x in tree.leaves(state["opt"]["m"])],
            "v": [_full(x) for x in tree.leaves(state["opt"]["v"])],
            "params": [_full(p) for p in tree.leaves(state["params"])]}


def _sharded_ranks(group, tmp: str) -> dict:
    """Rank body: every case on the 2×2 mesh; the elastic save."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.core import hints as H
    from repro_torch.core.dtensor import route_counts
    from repro_torch.core.policies import get_policy
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.comm import CommCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import shard_batch, shard_state
    from repro_torch.train.trainer import init_train_state
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out: dict = {"cases": {}, "bytes": {}}
    for arch, pol, micro in [(*c, 0) for c in CASES] + [(*MICRO_CASE,
                                                          MICRO)]:
        cfg, model, ts = _setup(arch, micro)
        policy = get_policy(pol, mesh, cfg)
        state = shard_state(policy, init_train_state(model, model.init(0),
                                                     ts))
        batch = shard_batch(policy, batch_for_step(cfg, 0, BATCH, SEQ,
                                                   device="cpu"))
        counted = arch == "qwen3-32b" and pol in COUNTED and not micro
        counter = CommCounter() if counted else None
        key = f"{arch}/{pol}" + (f"/micro{micro}" if micro else "")
        route_counts.update(dict.fromkeys(route_counts, 0))
        with H.sharding_hints(H.hints_for(policy)):
            out["cases"][key] = _step(model, ts, state, batch, counter)
        out["cases"][key]["routes"] = dict(route_counts)
        if counter is not None:
            c = counter.costs()
            out["bytes"][pol] = {"all-gather": c.collective_bytes[
                "all-gather"], "total": c.collective_total,
                "count": c.collective_count}
        if (arch, pol, micro) == (*CASES[0], 0):
            save_checkpoint(f"{tmp}/elastic_sharded", 1, state)
            save_checkpoint(f"{tmp}/elastic_plain", 1,
                            tree.map(_full, state))
    out["micro_refused"] = _refused_microbatch(mesh)
    out["lookup"] = _lookup(make_mesh((1, 4), ("data", "model"),
                                      device_type="cpu"))
    from repro_torch.launch import train as LT
    run = LT.run(LT.parser().parse_args(LAUNCH_ARGS + [
        "--ckpt-dir", f"{tmp}/launch"]), step_context=_fail_once())
    out["launch"] = {"history": run["history"],
                     "restarts": run["report"].restarts}
    return out


LOOKUP_VOCAB, LOOKUP_DIM = 64, 8


def _lookup_inputs():
    """A table, ids (with repeats, in every vocab shard) and the weights
    of the loss (out · w).sum(), from one seed."""
    g = torch.Generator().manual_seed(7)
    table = torch.randn(LOOKUP_VOCAB, LOOKUP_DIM, generator=g)
    ids = torch.randint(0, LOOKUP_VOCAB, (BATCH, SEQ), generator=g)
    w = torch.randn(BATCH, SEQ, LOOKUP_DIM, generator=g)
    return table, ids, w


def _lookup(mesh) -> dict:
    """The masked lookup on ``mesh``: the table in vocab shards over
    ``model``, the ids batch-sharded as ``layerwise_tp`` places tokens;
    the output and the table's gradient, gathered whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core.dtensor import embedding, route_counts
    table, ids, w = _lookup_inputs()
    table = distribute_tensor(table, mesh, [Replicate(), Shard(0)])
    table.requires_grad_(True)
    ids = distribute_tensor(ids, mesh, [Shard(0), Replicate()])
    before = route_counts["embed"]
    out = embedding(ids, table)
    routes = route_counts["embed"] - before
    placements = [p.is_shard(0) for p in out.placements], \
        [p.is_replicate() for p in out.placements]
    whole = out.full_tensor()
    (whole * w).sum().backward()
    return {"out": whole.detach(), "grad": table.grad.full_tensor(),
            "placements": placements, "routes": routes}


def _fail_once():
    """A ``step_context`` that raises one ``TransientError`` at
    LAUNCH_FAIL_AT (a forced restart from the latest checkpoint)."""
    import contextlib

    from repro_torch.train.fault_tolerance import TransientError
    failed: list[int] = []

    @contextlib.contextmanager
    def around(step: int):
        if step == LAUNCH_FAIL_AT and not failed:
            failed.append(step)
            raise TransientError(f"injected at step {step}")
        yield
    return around


def _refused_microbatch(mesh) -> str:
    """The error of a 1-row microbatch on the 2×2 mesh: 4 microbatches of
    a batch whose data shards hold 2 rows each."""
    from repro_torch.core.policies import get_policy
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import shard_batch, shard_state
    from repro_torch.train.trainer import init_train_state, make_grad_fn
    cfg, model, ts = _setup(MICRO_CASE[0], 1)
    policy = get_policy(MICRO_CASE[1], mesh, cfg)
    state = shard_state(policy, init_train_state(model, model.init(0), ts))
    batch = shard_batch(policy, batch_for_step(cfg, 0, BATCH, SEQ,
                                               device="cpu"))
    try:
        make_grad_fn(model, ts)(state["params"], batch)
    except ValueError as e:
        return str(e)
    return ""


def _elastic_ranks(group, tmp: str) -> dict:
    """Rank body: restore onto the re-carved mesh, then the next step."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.core.policies import get_policy
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import shard_batch
    from repro_torch.train.fault_tolerance import (elastic_remesh,
                                                   reshard_state)
    from repro_torch.train.trainer import init_train_state, named, state_spec
    cfg, model, ts = _setup(CASES[0][0])
    mesh = elastic_remesh(2, model_parallel=4, device_type="cpu")
    policy = get_policy(CASES[0][1], mesh, cfg)
    like = init_train_state(model, model.init(0), ts)
    shardings = named(mesh, state_spec(policy, like["params"]))
    shardings["opt"]["step"] = None
    state, extra = restore_checkpoint(f"{tmp}/elastic_sharded", like,
                                      shardings=shardings)
    restored = [_full(x) for x in tree.leaves(state)]
    placed = [str(x.placements) for x in tree.leaves(state["params"])]
    # the same parameters re-placed by another policy's specs
    moved = reshard_state(state["params"], get_policy(
        "fused_seq_zero3", mesh, cfg).param_spec(like["params"]), mesh)
    resharded = [_full(x) for x in tree.leaves(moved)]
    del moved
    batch = shard_batch(policy, batch_for_step(cfg, 1, BATCH, SEQ,
                                               device="cpu"))
    return {"mesh": tuple(mesh.shape), "step": extra["step"],
            "restored": restored, "placements": placed,
            "resharded": resharded,
            "next": _step(model, ts, state, batch)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    # each group meets at a file store of its own
    (tmp / "four").mkdir()
    (tmp / "two").mkdir()
    four = run_ranks(_sharded_ranks, 4, tmp / "four", str(tmp))
    two = run_ranks(_elastic_ranks, 2, tmp / "two", str(tmp))
    return {"tmp": tmp, "four": four, "two": two}


def _unsharded(arch: str, state=None, step: int = 0, micro: int = 0) -> dict:
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.train.trainer import init_train_state
    cfg, model, ts = _setup(arch, micro)
    if state is None:
        state = init_train_state(model, model.init(0), ts)
    return _step(model, ts, state,
                 batch_for_step(cfg, step, BATCH, SEQ, device="cpu"))


def _hold(got: dict, want: dict) -> None:
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= GRAD_RTOL * w.abs().max()
    for k in ("m", "v"):
        for g, w in zip(got[k], want[k], strict=True):
            assert (g - w).abs().max() <= GRAD_RTOL * w.abs().max(), k
    for p, w in zip(got["params"], want["params"], strict=True):
        assert (p.float() - w.float()).abs().max() <= UPDATE_ATOL


@pytest.mark.parametrize("arch,policy", CASES)
def test_sharded_step_matches_one_process(runs, arch, policy, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import dense_layers
    torch.set_num_threads(1)
    ranks = [r["cases"][f"{arch}/{policy}"] for r in runs["four"]]
    assert len({r["loss"] for r in ranks}) == 1      # every rank agrees
    dropped, route = [], MOE.route

    def counted(p, xt, cfg):
        r = route(p, xt, cfg)
        dropped.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(MOE, "route", counted)
    _hold(ranks[0], _unsharded(arch))
    cfg = get_config(arch, smoke=True)
    moe_layers = cfg.num_layers - dense_layers(cfg) if cfg.moe_num_experts \
        else 0
    # the global slot positions decide something only where one process
    # drops assignments
    assert len(dropped) == moe_layers and (not moe_layers or any(dropped))
    vocab_sharded = policy == "layerwise_tp" and cfg.vocab_size % 2 == 0
    for r in ranks:
        assert r["routes"] == {"moe_ffn": moe_layers,
                               "embed": int(vocab_sharded)}


def test_masked_lookup_matches_unsharded_embedding(runs):
    """The vocab-sharded lookup on 4 ranks: values and the table's gradient
    bit-equal to the unsharded ``F.embedding``'s, the output replicated
    over ``model`` (settled at once), one masked lookup a rank."""
    import torch.nn.functional as F
    table, ids, w = _lookup_inputs()
    table.requires_grad_(True)
    want = F.embedding(ids, table)
    (want * w).sum().backward()
    for r in (r["lookup"] for r in runs["four"]):
        assert r["routes"] == 1
        assert r["placements"] == ([True, False], [False, True])
        assert torch.equal(r["out"], want.detach())
        assert torch.equal(r["grad"], table.grad)


def test_sharded_microbatched_step_matches_one_process(runs):
    torch.set_num_threads(1)
    arch, policy = MICRO_CASE
    ranks = [r["cases"][f"{arch}/{policy}/micro{MICRO}"]
             for r in runs["four"]]
    assert len({r["loss"] for r in ranks}) == 1
    _hold(ranks[0], _unsharded(arch, micro=MICRO))


def test_microbatch_must_split_every_rank(runs):
    """A microbatch that is not a multiple of the data size raises on every
    rank (no row is dropped); one that does not split the batch raises in
    one process too."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.train.trainer import init_train_state, make_grad_fn
    for r in runs["four"]:
        assert "multiple of the data-parallel size" in r["micro_refused"]
    cfg, model, ts = _setup(MICRO_CASE[0], 3)
    state = init_train_state(model, model.init(0), ts)
    with pytest.raises(ValueError, match="does not split"):
        make_grad_fn(model, ts)(state["params"], batch_for_step(
            cfg, 0, BATCH, SEQ, device="cpu"))


def _jax_collective_bytes() -> dict:
    """JAX's all-gather and total bytes of the same step (2×2 mesh, 4 host
    devices, ``analyze_hlo``), in a subprocess."""
    code = f"""
import jax, json
from repro.configs import get_config
from repro.core.policies import get_policy
from repro.data.pipeline import make_batch_specs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import build_model
from repro.optim.adamw import adamw_init
from repro.train.trainer import TrainStepConfig, make_train_step, named, state_spec
set_mesh = getattr(jax, 'set_mesh', None) or (lambda m: m)
mesh = jax.make_mesh((2, 2), ('data', 'model'))
cfg = get_config('qwen3-32b', smoke=True)
m = build_model(cfg)
ps = jax.eval_shape(m.init, jax.random.PRNGKey(0))
res = {{}}
for name in {COUNTED!r}:
    pol = get_policy(name, mesh, cfg)
    batch = make_batch_specs(cfg, {BATCH}, {SEQ})
    state = {{'params': ps, 'opt': jax.eval_shape(adamw_init, ps)}}
    with set_mesh(mesh):
        comp = jax.jit(make_train_step(m, TrainStepConfig()), in_shardings=(
            named(mesh, state_spec(pol, ps)),
            named(mesh, pol.batch_spec(batch)))).lower(state, batch).compile()
    h = analyze_hlo(comp.as_text())
    res[name] = {{'all-gather': h.collective_bytes['all-gather'],
                  'total': h.collective_total}}
print(json.dumps(res))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collective_counts(runs):
    """layerwise_tp communicates, fused_seq may not; both packages' bytes
    at this shape are printed, not compared (PERF.md records them)."""
    got = runs["four"][0]["bytes"]
    assert got["layerwise_tp"]["total"] > 0
    assert got["fused_seq"]["total"] >= 0
    jax_bytes = _jax_collective_bytes()
    for pol in COUNTED:
        print(f"[collectives] qwen3-32b-smoke {BATCH}x{SEQ} 2x2 {pol}: port "
              f"all-gather {got[pol]['all-gather']:.0f} B, total "
              f"{got[pol]['total']:.0f} B ({got[pol]['count']} collectives, "
              f"per rank, eager, hints on); JAX all-gather "
              f"{jax_bytes[pol]['all-gather']:.0f} B, total "
              f"{jax_bytes[pol]['total']:.0f} B (compiled HLO, no hints)")


def test_elastic_restore_is_exact(runs):
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    tmp = runs["tmp"]
    sharded, plain = tmp / "elastic_sharded", tmp / "elastic_plain"
    step_dir = "step_00000001"
    names = sorted(os.listdir(plain / step_dir))
    assert names == sorted(os.listdir(sharded / step_dir))
    _, mismatch, errors = filecmp.cmpfiles(plain / step_dir,
                                           sharded / step_dir, names,
                                           shallow=False)
    assert not mismatch and not errors
    state, _ = restore_checkpoint(str(plain), _unsharded_like(),
                                  device="cpu")
    for r in runs["two"]:
        assert r["mesh"] == (1, 2) and r["step"] == 1
        assert any("Shard" in p for p in r["placements"])
        for got, want in zip(r["restored"], tree.leaves(state), strict=True):
            assert torch.equal(got, want)


def test_reshard_state_keeps_the_values(runs):
    for r in runs["two"]:
        n = len(r["resharded"])      # the params: the last leaves
        for got, want in zip(r["resharded"], r["restored"][-n:],
                             strict=True):
            assert torch.equal(got, want)


def test_launcher_on_four_ranks_across_a_restart(runs, tmp_path):
    """The launcher on the 2×2 mesh (the caller's gloo group), a restart
    from step 1's checkpoint: every rank reports the same losses, the
    unsharded trainer's within LOSS_RTOL."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import parser, train_config
    from repro_torch.train.trainer import init_train_state, make_train_step
    torch.set_num_threads(1)
    ranks = [r["launch"] for r in runs["four"]]
    assert all(r["restarts"] == 1 for r in ranks)
    got = [[loss for _, loss, _ in r["history"]] for r in ranks]
    assert all(g == got[0] for g in got)
    assert [s for s, _, _ in ranks[0]["history"]] == [0, 1, 2]
    cfg, model, _ = _setup("qwen3-32b")
    ts = train_config(parser().parse_args(LAUNCH_ARGS))
    state = init_train_state(model, model.init(0), ts)
    step = make_train_step(model, ts)
    for s, loss in enumerate(got[0]):
        state, metrics = step(state, batch_for_step(cfg, s, BATCH, SEQ,
                                                    device="cpu"))
        want = float(metrics["loss"])
        assert abs(loss - want) <= LOSS_RTOL * abs(want)


def test_elastic_next_step_matches_one_process(runs):
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    torch.set_num_threads(1)
    state, _ = restore_checkpoint(str(runs["tmp"] / "elastic_plain"),
                                  _unsharded_like(), device="cpu")
    want = _unsharded(CASES[0][0], state, step=1)
    for r in runs["two"]:
        _hold(r["next"], want)


def _unsharded_like():
    from repro_torch.train.trainer import init_train_state
    _, model, ts = _setup(CASES[0][0])
    return init_train_state(model, model.init(0), ts)
