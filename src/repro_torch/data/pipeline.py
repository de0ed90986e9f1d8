"""Deterministic synthetic data pipeline, the port of ``repro.data.pipeline``.

A batch is a pure function of the step, so that a restart replays the
same batches and a checkpoint made by either package resumes in the other
on the same data.  The JAX package draws its batches with ``jax.random``
(threefry2x32 keys, ``fold_in``, ``randint``, ``normal``); this module
carries its own threefry2x32 in numpy and JAX's derivations on top of it
(``jax/_src/prng.py`` and ``jax/_src/random.py`` of jax 0.9.0, with
``jax_threefry_partitionable`` on, its default), so the tokens are JAX's
token for token.  The normal draws for ``prefix_embed`` and ``enc_frames``
follow JAX's uniform → ``erfinv`` transform; ``torch.erfinv`` and XLA's
differ in the last float32 bits, so those agree to about 1e-8 at the 0.02
scale, not bit for bit.

A background thread prefetches batches, standing in for a corpus reader.
``make_batch_specs`` gives the batch's shapes and dtypes on the meta
device, the dry run's stand-ins.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

SEED = 20260714
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[int, int]


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1),
    uint32 arrays of one shape, under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the pair (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.full(1, data & _M32, np.uint32))
    return int(a[0]), int(b[0])


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """The flat index of every element as 64 bits, in two uint32 halves
    (``iota_2x32_shape``)."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(_M32)).astype(np.uint32)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split`` (the partitionable, fold-like form)."""
    a, b = threefry2x32(key, *_counters((num,)))
    return [(int(a[i]), int(b[i])) for i in range(num)]


def random_bits(key: Key, shape) -> np.ndarray:
    """32 random bits per element: the two hash words XORed."""
    a, b = threefry2x32(key, *_counters(shape))
    return a ^ b


def randint(key: Key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    words of bits per value, reduced mod the span in uint32 arithmetic."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape).astype(np.uint64)
    lo = random_bits(k2, shape).astype(np.uint64)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span       # wraps in uint32, as in JAX
    offset = (((hi % span) * mult + lo % span) & _M32) % span
    return (minval + offset.astype(np.int64)).astype(np.int32)


def uniform(key: Key, shape, dtype: torch.dtype, minval: float,
            maxval: float) -> torch.Tensor:
    """``jax.random.uniform``: random mantissa bits under the exponent of
    1.0, minus 1, scaled to [minval, maxval) in ``dtype`` (float32 or
    bfloat16; bfloat16 draws 8 bits, as JAX does for < 8 mantissa bits)."""
    bits = random_bits(key, shape)
    if dtype == torch.float32:
        one = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
        floats = torch.from_numpy(one.view(np.int32).copy()).view(
            torch.float32)
    elif dtype == torch.bfloat16:
        one = ((bits & np.uint32(0xFF)) >> np.uint32(1)) | np.uint32(0x3F80)
        floats = torch.from_numpy(one.astype(np.int16)).view(torch.bfloat16)
    else:
        raise TypeError(f"uniform: float32 or bfloat16, got {dtype}")
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    floats = floats - torch.tensor(1.0, dtype=dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(key: Key, shape, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2)·erfinv(u), u uniform on
    (nextafter(-1, 0), 1), in ``dtype`` (erfinv taken in float32)."""
    lo = -1.0 + torch.finfo(dtype).eps / 2       # nextafter(-1, 0)
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=dtype) \
        * torch.erfinv(u.to(torch.float32)).to(dtype)


def batch_for_step(cfg: ModelConfig, step: int, global_batch: int,
                   seq_len: int, *, host_slice: slice | None = None,
                   device=None) -> dict[str, torch.Tensor]:
    """Pure function step → batch: int32 ``tokens`` (n, seq_len) and
    next-token ``labels``, plus ``prefix_embed`` (n, num_prefix_tokens, d)
    for a VLM and ``enc_frames`` (n, encoder_seq_len, d) for an
    encoder-decoder, both N(0, 0.02²) in ``cfg.dtype``; n is the host
    slice's length (the whole batch by default), and each slice starts
    its own stream, as in JAX.  The tensors go to ``device`` (default
    ``cuda``)."""
    device = resolve_device(device)
    key = fold_in(prng_key(SEED), step)
    bsl = host_slice or slice(0, global_batch)
    n = bsl.stop - bsl.start
    key = fold_in(key, bsl.start)
    toks = torch.from_numpy(randint(key, (n, seq_len + 1), 0,
                                    max(2, cfg.vocab_size)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dt = getattr(torch, cfg.dtype)
    scale = torch.tensor(0.02, dtype=dt)       # JAX's weak 0.02, in dt
    if cfg.num_prefix_tokens:
        batch["prefix_embed"] = normal(
            fold_in(key, 1), (n, cfg.num_prefix_tokens, cfg.d_model),
            dt) * scale
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = normal(
            fold_in(key, 2), (n, cfg.encoder_seq_len, cfg.d_model),
            dt) * scale
    return {k: v.contiguous().to(device) for k, v in batch.items()}


def synthetic_batches(cfg: ModelConfig, global_batch: int, seq_len: int,
                      start_step: int = 0, *, prefetch: int = 2,
                      device=None) -> Iterator[tuple[int, dict]]:
    """Prefetching iterator over (step, batch), the batches made on the
    host by a background thread and moved to ``device`` (default
    ``cuda``) as they are taken."""
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            b = batch_for_step(cfg, step, global_batch, seq_len,
                               device="cpu")
            while not stop.is_set():
                try:
                    q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            step, b = q.get()
            yield step, {k: v.to(device) for k, v in b.items()}
    finally:
        stop.set()


def make_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                     dtype=None) -> dict[str, torch.Tensor]:
    """Meta-device tensors of every model input's shape and dtype — the dry
    run's stand-ins (shardable, no allocation): int32 ``tokens`` and
    ``labels`` (global_batch, seq_len), and ``prefix_embed`` and
    ``enc_frames`` in ``dtype`` (default ``cfg.dtype``) where the config
    has them."""
    dt = dtype or getattr(torch, cfg.dtype)

    def spec(shape, d):
        return torch.empty(shape, dtype=d, device="meta")
    specs = {"tokens": spec((global_batch, seq_len), torch.int32),
             "labels": spec((global_batch, seq_len), torch.int32)}
    if cfg.num_prefix_tokens:
        specs["prefix_embed"] = spec(
            (global_batch, cfg.num_prefix_tokens, cfg.d_model), dt)
    if cfg.is_encoder_decoder:
        specs["enc_frames"] = spec(
            (global_batch, cfg.encoder_seq_len, cfg.d_model), dt)
    return specs
