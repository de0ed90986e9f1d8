"""The port's windowed-halo attention (``repro_torch.core.seq_halo``)
against the JAX package's.

The JAX oracle runs once, in a subprocess with 8 host devices inside
``jax.set_mesh`` (as ``tests/test_seq_halo.py`` runs it, which this JAX
needs), and writes an ``.npz`` the port is held against.  The
process-group form runs on CPU ``gloo`` ranks (``gloo_ranks``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from gloo_ranks import run_ranks

from repro_torch.core import seq_halo as SH
from repro_torch.core.halo import LocalShards
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
B, S, HEADS, KV, D = 2, 128, 4, 2, 16
# (window, softcap); at S_shard = 16 the halo takes 1, 1 and 3 ring steps
CASES = [(8, 0.0), (16, 0.0), (48, 0.0), (16, 5.0)]
# (S, kv_heads, head_dim, window, n_shards, dtype_bytes)
BYTES_CASES = [(32768, 4, 256, 4096, 16, 2), (32768, 4, 256, 32768, 16, 2),
               (8192, 4, 256, 4096, 8, 4), (100, 2, 8, 1, 4, 2)]

ORACLE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.seq_halo import halo_vs_gather_bytes, windowed_attention_halo

CASES = %r
BYTES_CASES = %r
rng = np.random.default_rng(0)
q = rng.standard_normal((%d, %d, %d, %d)).astype(np.float32)
k = rng.standard_normal((%d, %d, %d, %d)).astype(np.float32)
v = rng.standard_normal(k.shape).astype(np.float32)
out = {"q": q, "k": k, "v": v}
mesh = jax.make_mesh((8,), ("model",))
for window, softcap in CASES:
    with jax.set_mesh(mesh):
        y = windowed_attention_halo(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window, mesh=mesh,
                                    softcap=softcap)
    out[f"y_{window}_{softcap}"] = np.asarray(y)
np.savez(sys.argv[1], **out)
print(json.dumps([halo_vs_gather_bytes(s, kv, hd, window=w, n_shards=n,
                                       dtype_bytes=db)
                  for s, kv, hd, w, n, db in BYTES_CASES]))
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("seq_halo_oracle") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    script = ORACLE % (CASES, BYTES_CASES, B, S, HEADS, D, B, S, KV, D)
    out = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    arrays = dict(np.load(path))
    arrays["bytes"] = json.loads(out.stdout.strip().splitlines()[-1])
    return arrays


def _qkv(oracle):
    return [torch.from_numpy(oracle[n]) for n in ("q", "k", "v")]


@pytest.mark.parametrize("window,softcap", CASES)
def test_windowed_halo_matches_jax(oracle, window, softcap):
    out = SH.windowed_attention_halo(*_qkv(oracle), window=window,
                                     n_shards=8, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), oracle[f"y_{window}_{softcap}"],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,softcap", CASES)
def test_windowed_halo_matches_monolithic(oracle, window, softcap):
    """Against ``attention_scores`` over the whole sequence with the same
    causal window mask."""
    q, k, v = _qkv(oracle)
    out = SH.windowed_attention_halo(q, k, v, window=window, n_shards=8,
                                     softcap=softcap)
    ref = L.attention_scores(q, k, v, L.causal_mask(S, S, window=window),
                             softcap)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_halo_bytes_match_jax(oracle):
    for args, want in zip(BYTES_CASES, oracle["bytes"]):
        s, kv, hd, w, n, db = args
        assert SH.halo_vs_gather_bytes(s, kv, hd, window=w, n_shards=n,
                                       dtype_bytes=db) == want


def test_halo_bytes_model():
    """As tests/test_seq_halo.py::test_halo_bytes_model."""
    r = SH.halo_vs_gather_bytes(32768, 4, 256, window=4096, n_shards=16)
    assert r["ratio"] == 15 / 2
    assert r["halo"] < r["all_gather"] / 7
    r2 = SH.halo_vs_gather_bytes(32768, 4, 256, window=32768, n_shards=16)
    assert r2["ratio"] == 1.0


def test_ring_halo_order_and_zeros():
    shards = LocalShards(4)
    x = torch.arange(1.0, 9.0).reshape(1, 8, 1, 1)
    ext = SH._ring_halo(shards.split(x), 2, shards)
    got = [t.flatten().tolist() for t in ext]
    assert got == [[0, 0, 0, 0, 1, 2], [0, 0, 1, 2, 3, 4],
                   [1, 2, 3, 4, 5, 6], [3, 4, 5, 6, 7, 8]]


def _attention_on_rank(group, q, k, v, window, softcap):
    """The process-group form and, under the rank's own thread settings,
    the one-process form."""
    kw = dict(window=window, n_shards=4, softcap=softcap)
    return (SH.windowed_attention_halo(q, k, v, group=group, **kw),
            SH.windowed_attention_halo(q, k, v, **kw))


def test_windowed_halo_process_group_bit_equal(oracle, tmp_path):
    q, k, v = _qkv(oracle)
    for pg, local in run_ranks(_attention_on_rank, 4, tmp_path, q, k, v, 48,
                               5.0):
        assert torch.equal(pg, local)


def test_windowed_halo_refuses_uneven_shards():
    q = torch.zeros(1, 30, 2, 4)
    with pytest.raises(ValueError, match="equal shards"):
        SH.windowed_attention_halo(q, q, q, window=4, n_shards=4)
