"""The port's ResNet18 in bf16 against the JAX package's bf16 ResNet18
(``init_resnet18(key, n, jnp.bfloat16)``: bf16 convs, γ, β and head, f32
BN statistics), with the JAX-made tree carried across by
``params_from_jax``.

The two bf16 forwards round at different places: JAX rounds each conv, the
normalised BN output, the BN's product and sum and the residual add to
bf16; the port's fused conv rounds once per conv + BN [+ add] [+ ReLU].
So each is held to the f32 forward of the same weights: the port's
distance from it at most ``DIST_FACTOR`` times JAX's own bf16 distance
(0.016·max|logits| at this case, 0.0096 with every BN at the identity; the
port's is 0.013), and top-1 equal to JAX's wherever the f32 margin exceeds
the sum of both distances."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as JR
from repro_torch.configs import get_config
from repro_torch.core import halo as H
from repro_torch.models import build_model
from repro_torch.models import resnet as R
from repro_torch.weights import params_from_jax

DIST_FACTOR = 1.5
BF16_ULP = 2.0**-7


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


@functools.cache
def _jax_tree():
    """A JAX-made bf16 ResNet18 (10 classes) with every BN moved off the
    identity: γ and β in bf16, mean and var in f32, as JAX keeps them."""
    tree = jax.tree.map(np.array, JR.init_resnet18(jax.random.PRNGKey(0), 10,
                                                   jnp.bfloat16))
    rng = np.random.default_rng(0)

    def perturb(node):
        for v in node.values():
            if isinstance(v, dict) and "var" in v:
                c = v["var"].shape[0]
                v["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["scale"] = np.asarray(jnp.asarray(
                    1 + rng.standard_normal(c) * 0.1, jnp.bfloat16))
                v["bias"] = np.asarray(jnp.asarray(
                    rng.standard_normal(c) * 0.1, jnp.bfloat16))
            elif isinstance(v, dict):
                perturb(v)
    perturb(tree)
    tree["fc_b"] = np.asarray(jnp.asarray(rng.standard_normal(10) * 0.1,
                                          jnp.bfloat16))
    return tree


@pytest.fixture(scope="module")
def case():
    tree = _jax_tree()
    x32 = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    xb = jnp.asarray(x32, jnp.bfloat16)
    jtree = jax.tree.map(jnp.asarray, tree)
    ref16 = np.asarray(jax.jit(JR.forward)(jtree, xb), np.float32)
    # the f32 forward of the same weights and images (bf16 values upcast)
    ref32 = np.asarray(jax.jit(JR.forward)(
        jax.tree.map(lambda a: a.astype(jnp.float32), jtree),
        xb.astype(jnp.float32)))
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    return tree, x, ref16, ref32


def _held(out: torch.Tensor, ref16: np.ndarray, ref32: np.ndarray) -> None:
    assert out.dtype == torch.bfloat16 and out.shape == ref32.shape
    got = out.float().numpy()
    assert np.isfinite(got).all()
    d_jax = np.abs(ref16 - ref32).max()
    d_port = np.abs(got - ref32).max()
    assert d_port <= DIST_FACTOR * d_jax, (d_port, d_jax)
    top2 = np.sort(ref32, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > d_port + d_jax
    assert (got.argmax(1) == ref16.argmax(1))[sure].all()


def test_jax_bf16_distance_is_the_measured_one(case):
    """The yardstick of the rule: JAX's own bf16 forward sits 0.016 of
    max|logits| from its f32 forward here."""
    _, _, ref16, ref32 = case
    rel = np.abs(ref16 - ref32).max() / np.abs(ref32).max()
    assert 0.002 < rel < 0.03, rel


def test_bf16_forward_held_to_jax(case):
    tree, x, ref16, ref32 = case
    p = params_from_jax(tree, "cpu")
    _held(R.forward(R.fold_bn(p), x), ref16, ref32)


def test_bf16_fused_groups_held_to_jax_and_equal_forward(case):
    tree, x, ref16, ref32 = case
    net = R.ResNet18(params=params_from_jax(tree, "cpu"), device="cpu")
    fused = net.forward_fused_groups(x)
    _held(fused, ref16, ref32)
    assert torch.equal(fused, net(x))   # the same calls in the same order


def test_params_from_jax_carries_a_bf16_tree_bit_for_bit(case):
    tree = case[0]
    got = params_from_jax(tree, "cpu")

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
                continue
            want = np.asarray(a[k])
            if want.dtype.name == "bfloat16":
                assert b[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    b[k].view(torch.int16).numpy(), _bits(want))
            else:
                assert b[k].dtype == torch.float32
                np.testing.assert_array_equal(b[k].numpy(), want)
    walk(tree, got)
    assert got["conv1"].dtype == got["bn1"]["scale"].dtype == torch.bfloat16
    assert got["bn1"]["var"].dtype == torch.float32


def test_fold_bn_keeps_scale_and_shift_f32_for_a_bf16_tree(case):
    """γ·rsqrt(var+eps) and β − mean·scale from the bf16 γ and β and the
    f32 statistics, in f32: not rounded to the tree's dtype."""
    p = params_from_jax(case[0], "cpu")
    f = R.fold_bn(p)
    for blk, name in (("s1b1", "bn1"), ("s2b1", "down_bn"), ("s4b2", "bn2")):
        bn, raw = f[blk][name], p[blk][name]
        assert bn["scale"].dtype == bn["shift"].dtype == torch.float32
        scale = raw["scale"].float() * torch.rsqrt(raw["var"] + R.BN_EPS)
        assert torch.equal(bn["scale"], scale)
        assert torch.equal(bn["shift"], raw["bias"].float()
                           - raw["mean"] * scale)
    assert f["s1b1"]["conv1"] is p["s1b1"]["conv1"]


def test_bf16_config_builds_and_serves_on_cpu():
    """A bf16 ResNet18 is resnet18 with both dtypes replaced, as in JAX
    (no config of its own): bf16 weights, f32 BN statistics and folded BN,
    bf16 logits."""
    cfg = dataclasses.replace(get_config("resnet18"), dtype="bfloat16",
                              param_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    net = model.init(0)
    assert net.params["conv1"].dtype == torch.bfloat16
    assert net.params["bn1"]["mean"].dtype == torch.float32
    assert net.folded["bn1"]["scale"].dtype == torch.float32
    images = torch.randn(2, 32, 32, 3,
                         generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    logits, _ = model.forward(net, {"images": images})
    assert logits.shape == (2, 1000) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


# The fused groups row-sharded in bf16 (``core.halo``), at the halo test's
# 128² input on the JAX-made tree's first three groups: interior shards
# equal the group run whole within one bf16 ulp plus 1e-4 of its size;
# the exact per-layer form everywhere.

def _rows_within(out: torch.Tensor, whole: torch.Tensor, rows) -> None:
    got, ref = out.float()[:, rows], whole.float()[:, rows]
    limit = BF16_ULP * ref.abs() + 1e-4 * whole.float().abs().max()
    assert ((got - ref).abs() <= limit).all(), (got - ref).abs().max()


@pytest.fixture(scope="module")
def folded(case):
    return R.fold_bn(params_from_jax(case[0], "cpu"))


# (shards, halo, shrink) per group, as tests/test_torch_halo.py runs them
GROUP_RUNS = [(4, 32, 8), (4, 8, 4), (2, 8, 4)]


@pytest.mark.parametrize("gi", range(3))
def test_bf16_fused_group_sharded_matches_whole(folded, gi):
    fns, _ = R.fused_group_fns(folded)
    x = torch.randn(1, 128, 128, 3,
                    generator=torch.Generator().manual_seed(4)).to(
        torch.bfloat16)
    for fn in fns[:gi]:
        x = fn(x)
    n, halo, shrink = GROUP_RUNS[gi]
    whole = fns[gi](x)
    out = H.run_fused_group(fns[gi], x, n, halo=halo, shrink=shrink)
    assert out.dtype == torch.bfloat16 and out.shape == whole.shape
    per = whole.shape[1] // n
    _rows_within(out, whole, slice(per, -per) if n > 2 else slice(0, 0))


def test_bf16_exact_chain_matches_whole(folded):
    """run_fused_group_exact on stage 1's four 3x3 convs in bf16: exact at
    every row, as in f32."""
    layers = [(lambda w, bn: (lambda t: R.conv_bn(w, bn, t, 1, 1, True)))(
        folded[blk][f"conv{c}"], folded[blk][f"bn{c}"])
        for blk in ("s1b1", "s1b2") for c in (1, 2)]
    x = R.stem(folded, torch.randn(
        1, 128, 128, 3, generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16))
    whole = x
    for fn in layers:
        whole = fn(whole)
    out = H.run_fused_group_exact(layers, x, 4, halo=4)
    assert out.dtype == torch.bfloat16
    _rows_within(out, whole, slice(None))
