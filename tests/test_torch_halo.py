"""The port's row-sharded fused groups (``repro_torch.core.halo``) and its
copy of the tiling rows (``repro_torch.core.tiling``) against the JAX
package's.

The JAX halo paths need more than one device before JAX is first
imported, and a mesh context on this JAX (``jax.set_mesh``), so the
oracle runs once, in a subprocess with 8 host devices, as
``tests/test_policies_sharded.py`` runs them; it writes an ``.npz`` of its
inputs, JAX-made parameters and outputs, which the port is held against.
The process-group form runs on CPU ``gloo`` ranks (``gloo_ranks``) and must
give the one-process form's bits.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from gloo_ranks import run_ranks

from repro.core.graph import build_resnet18 as jax_graph
from repro_torch.core import halo as H
from repro_torch.core import tiling as T
from repro_torch.models import layers as L
from repro_torch.models import resnet as R
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
TILES = (2, 4, 8)
# layer slices of ResNet18 at 224²: the three fused groups, then the stem
# alone and a lone 1x1/s2 downsample (whose tiles need fewer rows than
# their share: no halo)
SLICES = [(0, 8), (8, 15), (15, 22), (0, 2), (10, 11)]
# (shards, halo, shrink) per ResNet18 fused group at a 1x128x128 input
GROUP_RUNS = [(4, 32, 8), (4, 8, 4), (2, 8, 4)]
GROUP_INPUTS = [(1, 128, 128, 3), (1, 32, 32, 64), (1, 16, 16, 128)]
BIAS = 0.1     # the exact case's layers add it: masking must undo it

ORACLE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.graph import build_resnet18
from repro.core.halo import group_halo_rows, run_fused_group, run_fused_group_exact
from repro.models.layers import conv2d, init_conv
from repro.models.resnet import fused_group_fns, init_resnet18

GROUP_RUNS = %r
GROUP_INPUTS = %r
TILES = %r
SLICES = %r
BIAS = %r
out = {}
graph = build_resnet18(224)
for a, b in SLICES:
    for t in TILES:
        try:
            out[f"halo_rows_{a}_{b}_{t}"] = group_halo_rows(graph.slice(a, b),
                                                            t)
        except ValueError:
            out[f"halo_rows_{a}_{b}_{t}"] = -1

# ResNet18 at full width, every BN moved off the identity
p = jax.tree.map(np.array, init_resnet18(jax.random.PRNGKey(0), 10))
rng = np.random.default_rng(0)
def perturb(node, path):
    for k, v in node.items():
        if isinstance(v, dict) and "var" in v:
            c = v["var"].shape[0]
            v["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
            v["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            v["scale"] = (1 + rng.standard_normal(c) * 0.1).astype(np.float32)
            v["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        if isinstance(v, dict):
            perturb(v, path + k + "/")
        else:
            out["param/" + path + k] = v
perturb(p, "")
groups, _ = fused_group_fns(jax.tree.map(jnp.asarray, p))
for gi, ((n, halo, shrink), shape) in enumerate(zip(GROUP_RUNS, GROUP_INPUTS)):
    x = rng.standard_normal(shape).astype(np.float32)
    mesh = jax.make_mesh((n,), ("model",))
    with jax.set_mesh(mesh):
        y = run_fused_group(groups[gi], jnp.asarray(x), mesh, halo=halo,
                            shrink=shrink)
    out[f"x{gi}"] = x
    out[f"sharded{gi}"] = np.asarray(y)
    out[f"mono{gi}"] = np.asarray(groups[gi](jnp.asarray(x)))

# tests/test_policies_sharded.py::test_halo_exchange_matches_monolithic
key = jax.random.PRNGKey(0)
ws = [init_conv(jax.random.fold_in(key, i), 3, 3, 16, 16, jnp.float32)
      for i in range(4)]
layer_fns = [(lambda w: (lambda t: jax.nn.relu(conv2d(w, t, 1, 1) + BIAS)))(w)
             for w in ws]
x = jax.random.normal(key, (2, 64, 64, 16))
ref = x
for fn in layer_fns:
    ref = fn(ref)
mesh = jax.make_mesh((8,), ("model",))
with jax.set_mesh(mesh):
    y = run_fused_group_exact(layer_fns, x, mesh, halo=4)
out["exact_x"] = np.asarray(x)
out["exact_w"] = np.stack([np.asarray(w) for w in ws])
out["exact_sharded"] = np.asarray(y)
out["exact_mono"] = np.asarray(ref)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("halo_oracle") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    script = ORACLE % (GROUP_RUNS, GROUP_INPUTS, TILES, SLICES, BIAS)
    out = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _params(oracle):
    tree = {}
    for key, arr in oracle.items():
        if key.startswith("param/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return R.fold_bn(params_from_jax(tree, "cpu"))


# --- the tiling rows ----------------------------------------------------------

def test_layer_records_match_jax_graph():
    jax_layers = jax_graph(224).layers
    port = T.build_resnet18(224)
    assert len(port) == len(jax_layers) - 2       # no global pool, no head
    for got, want in zip(port, jax_layers):
        assert (got.name, got.kind, got.iy, got.oy, got.k, got.stride,
                got.padding, got.input_of, got.residual_of) == (
            want.name, want.kind.value, want.iy, want.oy, want.kh,
            want.stride, want.padding, want.input_of, want.residual_of)
        assert want.kh == want.kw and want.iy == want.ix


def test_fused_groups_are_the_first_slices():
    chain = T.build_resnet18(224)
    assert T.resnet18_fused_groups(224) == [chain[a:b] for a, b in SLICES[:3]]


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("a,b", SLICES)
def test_group_halo_rows_match_jax(oracle, a, b, tiles):
    group = T.build_resnet18(224)[a:b]
    want = int(oracle[f"halo_rows_{a}_{b}_{tiles}"])
    if want < 0:
        with pytest.raises(ValueError, match="not divisible"):
            H.group_halo_rows(group, tiles)
    else:
        assert H.group_halo_rows(group, tiles) == want


# --- exchange_halo ------------------------------------------------------------

def _ramp():
    return torch.arange(4 * 8, dtype=torch.float32).reshape(1, 32, 1, 1)


def _exchange_on_rank(group, x):
    shards = H.RankShards(group)
    return H.exchange_halo(shards.split(x), 2, 2, shards)


def test_exchange_halo_boundaries():
    """As tests/test_policies_sharded.py::test_exchange_halo_boundaries."""
    shards = H.LocalShards(4)
    y = torch.stack(H.exchange_halo(shards.split(_ramp()), 2, 2, shards))
    y = y.reshape(4, 12).numpy()
    assert (y[0, :2] == 0).all()
    np.testing.assert_array_equal(y[1, :2], [6.0, 7.0])
    np.testing.assert_array_equal(y[0, -2:], [8.0, 9.0])
    assert (y[3, -2:] == 0).all()
    np.testing.assert_array_equal(y[2], np.arange(14, 26))


def test_exchange_halo_process_group_bit_equal(tmp_path):
    x = torch.randn(2, 32, 3, 5, generator=torch.Generator().manual_seed(0))
    shards = H.LocalShards(4)
    local = H.exchange_halo(shards.split(x), 2, 2, shards)
    ranks = run_ranks(_exchange_on_rank, 4, tmp_path, x)
    for r in range(4):
        assert ranks[r].is_contiguous() and local[r].is_contiguous()
        assert torch.equal(ranks[r], local[r])


@pytest.mark.parametrize("up,down", [(9, 0), (0, 9), (-1, 2)])
def test_exchange_halo_refuses_a_halo_longer_than_a_shard(up, down):
    shards = H.LocalShards(4)
    with pytest.raises(ValueError, match="halo"):
        H.exchange_halo(shards.split(_ramp()), up, down, shards)


def test_exchange_halo_one_sided():
    shards = H.LocalShards(4)
    y = H.exchange_halo(shards.split(_ramp()), 0, 3, shards)
    assert [t.shape[1] for t in y] == [11] * 4
    np.testing.assert_array_equal(y[1].flatten().numpy(),
                                  list(range(8, 16)) + [16, 17, 18])
    assert (y[3][:, 8:] == 0).all()


# --- run_fused_group ----------------------------------------------------------

@pytest.mark.parametrize("gi", range(3))
def test_run_fused_group_matches_jax_at_every_row(oracle, gi):
    """Boundary rows included: the zero halo rows of the first and last
    shards pass through BN's shift and reach the stem's max pool in both
    packages alike."""
    n, halo, shrink = GROUP_RUNS[gi]
    groups, _ = R.fused_group_fns(_params(oracle))
    x = torch.from_numpy(oracle[f"x{gi}"])
    out = H.run_fused_group(groups[gi], x, n, halo=halo, shrink=shrink)
    want = oracle[f"sharded{gi}"]
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)
    # the boundary deviation is real, so the rows above are not vacuous
    mono = oracle[f"mono{gi}"]
    np.testing.assert_allclose(groups[gi](x).numpy(), mono, atol=ATOL,
                               rtol=0)
    dev = np.abs(want - mono).max(axis=(0, 2, 3))
    rows = mono.shape[1] // n
    assert dev[:rows].max() > 0.1 and dev[-rows:].max() > 0.1
    assert dev[rows:-rows].max(initial=0.0) <= ATOL


def test_run_fused_group_refuses_uneven_shards():
    with pytest.raises(ValueError, match="equal shards"):
        H.run_fused_group(lambda t: t, torch.zeros(1, 30, 4, 1), 4, halo=2,
                          shrink=2)


def test_run_fused_group_refuses_a_halo_longer_than_a_shard():
    with pytest.raises(ValueError, match="halo"):
        H.run_fused_group(lambda t: t, torch.zeros(1, 32, 4, 1), 4, halo=9,
                          shrink=9)


# --- run_fused_group_exact ----------------------------------------------------

def _exact_layers(ws):
    return [(lambda w: (lambda t: torch.relu(L.conv2d(w, t, 1, 1) + BIAS)))(w)
            for w in ws]


def _exact_on_rank(group, ws, x):
    """The process-group form and, under the rank's own thread settings,
    the one-process form."""
    fns = _exact_layers(ws)
    return (H.run_fused_group_exact(fns, x, 8, halo=4, group=group),
            H.run_fused_group_exact(fns, x, 8, halo=4))


@pytest.fixture(scope="module")
def exact(oracle):
    ws = list(torch.from_numpy(oracle["exact_w"]))
    x = torch.from_numpy(oracle["exact_x"])
    return ws, x, H.run_fused_group_exact(_exact_layers(ws), x, 8, halo=4)


def test_run_fused_group_exact_matches_jax_and_monolithic(oracle, exact):
    ws, x, out = exact
    np.testing.assert_allclose(out.numpy(), oracle["exact_sharded"],
                               atol=ATOL, rtol=0)
    mono = x
    for fn in _exact_layers(ws):
        mono = fn(mono)
    np.testing.assert_allclose(out.numpy(), mono.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(mono.numpy(), oracle["exact_mono"], atol=ATOL,
                               rtol=0)


def test_run_fused_group_exact_process_group_bit_equal(exact, tmp_path):
    ws, x, out = exact
    for pg, local in run_ranks(_exact_on_rank, 8, tmp_path, ws, x):
        assert torch.equal(pg, local)
        np.testing.assert_allclose(pg.numpy(), out.numpy(), atol=ATOL, rtol=0)


def test_process_group_needs_n_shards_ranks(monkeypatch):
    monkeypatch.setattr(H.dist, "get_world_size", lambda group: 4)
    monkeypatch.setattr(H.dist, "get_rank", lambda group: 0)
    with pytest.raises(ValueError, match="4 ranks"):
        H.run_fused_group_exact([], torch.zeros(1, 16, 2, 1), 8, halo=1,
                                group=object())
