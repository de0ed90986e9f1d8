"""The port's ResNet18 against the JAX package's, with JAX-made parameters
carried across by ``params_from_jax``; the port's weight import, entry
points and import boundary."""

import ast
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import OpKind, build_resnet18
from repro.models import resnet as JR
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import resnet as R
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4   # as test_arch_smoke.py::test_resnet18_smoke


@functools.cache
def _jax_init(num_classes, seed):
    init = jax.jit(JR.init_resnet18, static_argnums=1)
    return init(jax.random.PRNGKey(seed), num_classes)


def _jax_params(num_classes=10, seed=0):
    """JAX-made params as numpy, with every BN's mean, var, γ and β moved
    off the identity so that folding them into scale/shift matters."""
    tree = jax.tree.map(np.array, _jax_init(num_classes, seed))
    rng = np.random.default_rng(seed)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict) and "var" in v:
                c = v["var"].shape[0]
                v["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["scale"] = (1 + rng.standard_normal(c) * 0.1).astype(
                    np.float32)
                v["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
            elif isinstance(v, dict):
                perturb(v)
    perturb(tree)
    tree["fc_b"] = (rng.standard_normal(num_classes) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def case():
    tree = _jax_params()
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JR.forward)(jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(x)))
    return tree, x, ref


def test_resnet18_logits_match_jax(case):
    tree, x, ref = case
    p = params_from_jax(tree, "cpu")
    out = R.forward(R.fold_bn(p), torch.from_numpy(x))
    assert out.shape == (2, 10) and np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_fused_groups_equal_forward(case):
    tree, x, _ = case
    net = R.ResNet18(params=params_from_jax(tree, "cpu"), device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(net.forward_fused_groups(xt).numpy(),
                               net(xt).numpy(), atol=1e-5)


def test_fold_bn_matches_batchnorm(case):
    """scale·y + shift of a folded BN is inference BN of y, for every BN
    of the tree; the conv weights are carried over, not copied."""
    tree, _, _ = case
    p = params_from_jax(tree, "cpu")
    f = R.fold_bn(p)
    rng = np.random.default_rng(2)
    for blk in ("s1b1", "s2b1"):
        for name in [k for k in p[blk] if "bn" in k]:
            c = p[blk][name]["var"].shape[0]
            y = torch.from_numpy(rng.standard_normal((2, 3, 3, c)).astype(
                np.float32))
            bn = f[blk][name]
            np.testing.assert_allclose(
                (y * bn["scale"] + bn["shift"]).numpy(),
                L.batchnorm(p[blk][name], y).numpy(), atol=1e-5)
    assert f["s2b1"]["down"] is p["s2b1"]["down"] and f["fc_w"] is p["fc_w"]


def test_module_folds_bn_once(monkeypatch, case):
    """ResNet18 folds BN when it is built; its forwards fold nothing and
    match the JAX forward."""
    tree, x, ref = case
    net = R.ResNet18(params=params_from_jax(tree, "cpu"), device="cpu")

    def refold(p):
        raise AssertionError("BN folded in a forward")
    monkeypatch.setattr(R, "fold_bn", refold)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(net(xt).numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(net.forward_fused_groups(xt).numpy(), ref,
                               atol=ATOL)


def test_build_model_serves_on_cpu(case):
    _, x, _ = case
    model = build_model(get_config("resnet18"), device="cpu")
    net = model.init(0)
    logits, aux = model.forward(net, {"images": torch.from_numpy(x)})
    assert logits.shape == (2, 1000) and torch.isfinite(logits).all()
    assert aux.item() == 0.0
    with pytest.raises(NotImplementedError):
        model.decode_step(net, None, None, 0)


def test_module_params_keep_jax_layout(case):
    tree, _, _ = case
    net = R.ResNet18(params=params_from_jax(tree, "cpu"), device="cpu")
    got = net.params

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(b[k].numpy(), a[k])
    walk(tree, got)
    assert sum(t.numel() for t in net.buffers()) == sum(
        v.size for v in jax.tree.leaves(tree))


def test_twenty_fused_convs_per_forward(monkeypatch, case):
    """Every conv, with its BN and any residual add and ReLU, is one
    fused-conv call, with the geometry of the conv layers of the paper's
    graph (``repro.core.graph.build_resnet18``); the downsample comes
    before the conv2 that adds it."""
    tree, x, _ = case
    calls = []
    real = R.ops.fused_conv

    def spy(x, w, *a, **kw):
        y = real(x, w, *a, **kw)
        calls.append({"geom": (w.shape[2], w.shape[3], w.shape[0],
                               kw["stride"], kw["padding"], x.shape[1],
                               y.shape[1]),
                      "relu": kw["relu"], "add": kw["residual"] is not None})
        return y
    monkeypatch.setattr(R.ops, "fused_conv", spy)
    R.forward(R.fold_bn(params_from_jax(tree, "cpu")), torch.from_numpy(x))
    graph = build_resnet18(x.shape[1], 10).layers
    want = [(g.cin, g.cout, g.kh, g.stride, g.padding, g.iy, g.oy)
            for g in graph if g.kind in (OpKind.CONV_BN, OpKind.CONV_BN_RELU)]
    assert len(calls) == 20
    assert sorted(c["geom"] for c in calls) == sorted(want)
    assert sum(c["add"] for c in calls) == sum(
        g.kind == OpKind.ADD_RELU for g in graph) == 8
    downs = [i for i, c in enumerate(calls) if c["geom"][2] == 1]
    assert len(downs) == 3
    for i in downs:
        assert not calls[i]["relu"] and not calls[i]["add"]
        assert calls[i + 1]["add"] and calls[i + 1]["relu"]  # conv2: ADD_RELU


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_torch_init_matches_jax_shapes():
    ref = _shapes(_jax_init(10, 0))
    got = _shapes(R.init_resnet18(torch.Generator().manual_seed(0), 10))
    assert got == ref


# --- params_from_jax rejects bad trees ------------------------------------

def _broken(kind):
    tree = _jax_params()
    if kind == "missing":
        del tree["s2b1"]["down_bn"]
    elif kind == "extra":
        tree["s1b1"]["down"] = np.zeros((1, 1, 64, 64), np.float32)
    elif kind == "shape":
        tree["s3b2"]["conv1"] = tree["s3b2"]["conv1"][:, :, :, :128]
    elif kind == "not_dict":
        tree["bn1"] = np.ones(64, np.float32)
    elif kind == "dtype":
        tree["fc_w"] = tree["fc_w"].astype(np.int32)
    elif kind == "no_head":
        del tree["fc_b"]
    return tree


@pytest.mark.parametrize("kind,exc", [("missing", KeyError),
                                      ("extra", KeyError),
                                      ("shape", ValueError),
                                      ("not_dict", TypeError),
                                      ("dtype", TypeError),
                                      ("no_head", KeyError)])
def test_params_from_jax_rejects(kind, exc):
    with pytest.raises(exc):
        params_from_jax(_broken(kind), "cpu")


# --- entry points: the card unless the CPU is asked for --------------------

@pytest.mark.parametrize("entry", [
    lambda dev: build_model(get_config("resnet18"), device=dev),
    lambda dev: R.ResNet18(4, device=dev),
    lambda dev: params_from_jax(_jax_params(), dev),
    resolve_device,
])
def test_entry_points_need_a_card_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry("cuda")
    entry("cpu")


def test_get_config_refuses_unknown_and_serves_whisper():
    with pytest.raises(KeyError, match="no port of config"):
        get_config("no-such-model")
    cfg = get_config("whisper-large-v3")   # test_arch_smoke.py's dims
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (32, 1280, 20, 20, 5120, 51866)
    assert cfg.is_encoder_decoder and cfg.encoder_layers == 32
    assert cfg.encoder_seq_len == 1500


# --- examples/resnet_pim_torch.py -----------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "resnet_pim_torch", ROOT / "examples" / "resnet_pim_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_the_plain_path_on_cpu(capsys):
    """The numerics half of examples/resnet_pim_ppa.py, at its 2x96x96."""
    _example().main(["--cpu"])
    out = capsys.readouterr().out
    assert "fused-group execution == monolithic ✓ (logits (2, 1000), on cpu)" \
        in out
    assert "(the plain path) == plain PyTorch reference ✓" in out
    assert "examples/resnet_pim_ppa.py" in out


def test_example_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example().main([])


# --- import boundary ---------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "xlstm_drift.py",
        ROOT / "flash_f32_phases.py", ROOT / "flash_bwd_precision.py",
        ROOT / "examples" / "resnet_pim_torch.py",
        ROOT / "examples" / "serve_lm_torch.py",
        ROOT / "examples" / "train_lm_torch.py"]


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_repro(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.models, repro_torch.weights, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.core.halo, repro_torch.core.seq_halo, "
            "repro_torch.core.tiling, repro_torch.optim.compression, "
            "repro_torch.data.pipeline, repro_torch.train.trainer, "
            "repro_torch.train.fault_tolerance, repro_torch.checkpoint; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
