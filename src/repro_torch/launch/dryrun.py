"""Multi-pod dry run: every (arch × shape × mesh) cell's sharded step on fake
ranks, the port of ``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware.  JAX's dry
run lowers and compiles on 512 placeholder host devices; the port runs the
step itself, on a FAKE process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``: every collective returns at once) as torchtitan's dry run
does, with the local shards on the ``meta`` device: shapes and dtypes
only, no allocation, no arithmetic (a fake tensor of the CPU would do as
much, but DTensor's own placement arithmetic makes small tensors that
``FakeTensorMode`` would fake too, and reads them back).  For every
runnable cell it

    1. builds the model, the policy and the state (or params, or params and
       cache) as DTensors of meta local shards (``make_batch_specs``'s
       stand-ins for the batch), placed by the policy's specs,
    2. runs the cell's step on rank 0's shards: a train step (``train``),
       the forward (``prefill``) or one decode step (``decode``), through
       the same model code, kernels' DTensor route and DTensor sharding
       propagation as a real run; a sharding mismatch or an op DTensor
       cannot place fails here,
    3. records the per-device argument bytes (exact, from the local shard
       shapes), the per-device FLOPs and the collective bytes by kind
       (``launch/comm.py``; the analogue of JAX's HLO analysis), the ops
       whose work a route repeated on every rank of a mesh dim that the
       policy's specs shard (``computed_replicated``, from
       ``core.dtensor.note_computed_replicated``: the expert-parallel MoE
       FFN names ``moe_ffn`` where it must replicate both its tokens and
       its experts on such a dim), and the status: ``ok``, ``fail`` with
       the error, or ``skip``.  The embedding lookup never names itself:
       a vocab-sharded table takes the masked lookup on the local rows,
       and under ``fused_seq_zero3`` the data-sharded table is gathered at
       use like every weight of that policy (its bytes count as
       all-gather), while each rank looks up only its own tokens.

An op whose result depends on the data (``.item()``) raises on meta
tensors, so such a cell fails and is reported, never hidden; the MoE's
buffers take static shapes (``models/moe.py``), so its FLOPs and
collectives are counted.  The mesh is on the CPU and the kernels' DTensor
route runs their plain versions on the meta shards: a dry run needs no
card.  The fake process group lives in this process only; a caller that
has one keeps it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--cells a@s,b@s]
        [--mesh single|multi|both|DxM] [--policy fused_seq|layerwise_tp|
        fused_seq_zero3] [--out results.json] [--smoke] [--layers N]

Exit code 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import hints as hint_mod
from repro_torch.core.dtensor import is_dtensor, recording_gathers
from repro_torch.core.policies import get_policy, placements, repair_spec, \
    P
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch.cells import Cell, all_cells, microbatch_for
from repro_torch.launch.comm import HBM_UNAVAILABLE, CommCounter
from repro_torch.launch.mesh import make_mesh, production_shape
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.trainer import (TrainStepConfig, make_serve_step,
                                       make_train_step, state_spec)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(like_tree, spec_tree, mesh):
    """DTensors of meta local shards, shaped and typed like ``like_tree``'s
    leaves, placed by ``spec_tree`` (no collective: each rank slices its
    own)."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, s):
        whole = torch.empty(x.shape, dtype=x.dtype, device="meta")
        return distribute_tensor(whole, mesh, placements(s, mesh),
                                 src_data_rank=None)
    return tree.map(put, like_tree, spec_tree)


def argument_bytes(*trees) -> int:
    """Bytes of every leaf's local shard on this device."""
    total = 0
    for t in trees:
        for x in tree.leaves(t):
            if isinstance(x, torch.Tensor):
                local = x.to_local() if is_dtensor(x) else x
                total += local.numel() * local.element_size()
    return total


def run_cell(cell: Cell, mesh, policy_name: str, *, remat: bool = True,
             hints: bool = False, loss_chunk: int = 0, micro: int = 0,
             smoke: bool = False, layers: int = 0) -> dict:
    """The record of one cell on one mesh (see the module's docstring);
    ``layers`` cuts the config to its first N layers (0: all)."""
    cfg = get_config(cell.arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, device="meta")
    policy = get_policy(policy_name, mesh, cfg)
    params_shapes = model.init(0).params
    pspec = policy.param_spec(params_shapes)
    data_par = 1
    for a, n in zip(mesh.mesh_dim_names, mesh.shape):
        if a in ("pod", "data"):
            data_par *= n
    shape = cell.shape
    hint_ctx = hint_mod.sharding_hints(hint_mod.hints_for(policy)) \
        if hints else contextlib.nullcontext()
    counter = CommCounter()
    t0 = time.monotonic()
    if shape.kind == "train":
        micro = micro or microbatch_for(cell.arch, shape, data_par)
        ts = TrainStepConfig(microbatch=micro, remat=remat,
                             loss_chunk=loss_chunk)
        sspec = state_spec(policy, params_shapes)
        state = {"params": _placed(params_shapes, sspec["params"], mesh),
                 "opt": adamw_init(params_shapes)}
        for k in ("m", "v"):
            state["opt"][k] = _placed(state["opt"][k], sspec["opt"][k],
                                      mesh)
        for p in tree.leaves(state["params"]):
            p.requires_grad_(True)
        batch_meta = make_batch_specs(cfg, shape.global_batch,
                                      shape.seq_len)
        batch = _placed(batch_meta, policy.batch_spec(batch_meta), mesh)
        args = (state, batch)
        step = make_train_step(model, ts)

        def fn():
            return step(state, batch)
    elif shape.kind == "prefill":
        params = _placed(params_shapes, pspec, mesh)
        batch_meta = make_batch_specs(cfg, shape.global_batch,
                                      shape.seq_len)
        batch = _placed(batch_meta, policy.batch_spec(batch_meta), mesh)
        args = (params, batch)

        @torch.no_grad()
        def fn():
            from repro_torch.train.trainer import sharded
            with sharded(tree.leaves(params)):
                return model.forward(model.bind(params), batch,
                                     remat=False, return_hidden=True)
    else:  # decode
        params = _placed(params_shapes, pspec, mesh)
        cache_meta = model.init_cache(shape.global_batch, shape.seq_len)
        cache = _placed(cache_meta, policy.cache_spec(cache_meta), mesh)
        tok_spec = repair_spec(P(policy._dp(), None),
                               (shape.global_batch, 1), mesh)
        tok = _placed({"t": torch.empty((shape.global_batch, 1),
                                        dtype=torch.int32,
                                        device="meta")},
                      {"t": tok_spec}, mesh)["t"]
        args = (params, cache, tok)
        serve = make_serve_step(model)

        def fn():
            from repro_torch.train.trainer import sharded
            with sharded(tree.leaves(params)):
                return serve(model.bind(params), cache, tok,
                             shape.seq_len - 1)
    arg_bytes = argument_bytes(*args)
    with hint_ctx, counter, recording_gathers() as gathered:
        fn()
    costs = counter.costs()
    return {"cell": cell.key, "mesh": "x".join(map(str, mesh.shape)),
            "status": "ok", "run_s": round(time.monotonic() - t0, 2),
            "bytes_per_device": {"argument": arg_bytes},
            "cost": {"flops": costs.flops},
            "collectives": costs.record(),
            "computed_replicated": sorted(gathered),
            "flops_per_device": costs.flops,
            "hbm_bytes_per_device": HBM_UNAVAILABLE,
            "num_devices": mesh.size()}


def _meshes(choice: str) -> list[tuple[str, tuple, tuple]]:
    out = []
    if choice in ("single", "both"):
        out.append(("single_pod_16x16", *production_shape()))
    if choice in ("multi", "both"):
        out.append(("multi_pod_2x16x16", *production_shape(multi_pod=True)))
    if not out:
        d, m = (int(v) for v in choice.split("x"))
        out.append((f"mesh_{d}x{m}", (d, m), ("data", "model")))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="",
                    help="comma-separated cell keys (default: all)")
    ap.add_argument("--mesh", default="both",
                    help="single, multi, both, or DxM (data×model)")
    ap.add_argument("--policy", default="fused_seq",
                    choices=["fused_seq", "layerwise_tp",
                             "fused_seq_zero3"])
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--hints", action="store_true",
                    help="enable the sharding hints (core.hints)")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="chunked head+CE sequence slice (0=off)")
    ap.add_argument("--micro", type=int, default=0,
                    help="override global microbatch size (0=auto)")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke reductions at the cells' "
                         "shapes")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut each config to its first N layers (0: all)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    wanted = set(filter(None, args.cells.split(",")))
    results = []
    for cell in all_cells():
        if wanted and cell.key not in wanted:
            continue
        if cell.skip_reason:
            results.append({"cell": cell.key, "status": "skip",
                            "reason": cell.skip_reason})
            print(f"SKIP {cell.key}: {cell.skip_reason}")
            continue
        for mesh_name, shape, axes in _meshes(args.mesh):
            tag = f"{cell.key} [{mesh_name}] policy={args.policy}"
            try:
                n = 1
                for s in shape:
                    n *= s
                with fake_group(n):
                    mesh = make_mesh(shape, axes, device_type="cpu")
                    rec = run_cell(cell, mesh, args.policy,
                                   remat=not args.no_remat, hints=args.hints,
                                   loss_chunk=args.loss_chunk,
                                   micro=args.micro, smoke=args.smoke,
                                   layers=args.layers)
                rec["mesh_name"] = mesh_name
                rec["policy"] = args.policy
                results.append(rec)
                coll = rec["collectives"]
                print(f"OK   {tag} run={rec['run_s']}s argument_bytes="
                      f"{rec['bytes_per_device']['argument']} flops="
                      f"{rec['flops_per_device']:.6e} collectives="
                      + json.dumps({k: v for k, v in coll.items() if v})
                      + " computed_replicated="
                      + ",".join(rec["computed_replicated"] or ["none"]))
            except Exception as e:  # noqa: BLE001 - report and continue
                results.append({"cell": cell.key, "mesh_name": mesh_name,
                                "policy": args.policy, "status": "fail",
                                "error": f"{type(e).__name__}: {e}"})
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r.get("status") == "ok")
    fail = sum(1 for r in results if r.get("status") == "fail")
    skip = sum(1 for r in results if r.get("status") == "skip")
    print(f"\n=== dry-run: {ok} ok, {fail} fail, {skip} skip "
          f"→ {args.out} ===")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
