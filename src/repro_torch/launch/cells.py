"""The assigned (architecture × input-shape) cell registry — 40 cells, the
port's own copy of ``repro.launch.cells`` over its ``ARCH_REGISTRY``.

Shapes (assignment):
    train_4k      seq 4096,    global_batch 256   (training step)
    prefill_32k   seq 32768,   global_batch 32    (inference prefill)
    decode_32k    seq 32768,   global_batch 128   (one-token decode w/ cache)
    long_500k     seq 524288,  global_batch 1     (long-context decode)

``long_500k`` requires sub-quadratic attention: it RUNS for the SSM/hybrid
archs (zamba2, xlstm — O(1)-state decode) and is SKIPPED for the 8
full-attention archs (incl. gemma2, whose alternating global layers are
still quadratic).  All 10 archs have decoders, so no decode-shape skips.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import ARCH_REGISTRY, get_config


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

LONG_OK = {"zamba2-2.7b", "xlstm-1.3b"}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: Shape
    skip_reason: str | None = None

    @property
    def key(self) -> str:
        return f"{self.arch}@{self.shape.name}"


def all_cells() -> list[Cell]:
    cells: list[Cell] = []
    for arch in ARCH_REGISTRY:
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and arch not in LONG_OK:
                skip = ("full quadratic attention at 512k seq — skipped per "
                        "assignment (sub-quadratic archs only)")
            cells.append(Cell(arch, shape, skip))
    return cells


def runnable_cells() -> list[Cell]:
    return [c for c in all_cells() if c.skip_reason is None]


def microbatch_for(arch: str, shape: Shape, data_parallel: int) -> int:
    """Per-device microbatch plan for training cells: accumulate so the
    live micro-activation set fits HBM (tuned per model size)."""
    if shape.kind != "train":
        return 0
    per_dev = max(1, shape.global_batch // data_parallel)
    cfg = get_config(arch)
    # rough activation budget: bigger d_model/layers → smaller micro
    big = cfg.d_model * cfg.num_layers
    if big >= 200_000:        # qwen3-32b class
        micro = 1
    elif big >= 64_000:       # 2-4B class
        micro = 2
    else:
        micro = 4
    micro = min(micro, per_dev)
    # microbatch config is in GLOBAL batch units per accumulation slice
    return micro * data_parallel
