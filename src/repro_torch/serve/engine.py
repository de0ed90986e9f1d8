"""Batched serving engine: lock-step greedy decode over a KV cache, as in
the JAX package's ``repro.serve.engine``.

``run_lockstep`` takes a fresh cache per call, steps every prompt token by
token through ``decode_step`` (the prompt is fed, not prefilled in one
forward), then decodes greedily with the argmax taken on the host.  The
port has no ``jit``: it calls ``decode_step`` directly.  The JAX engine's
slot queue (``submit``/``_admit``) and its ``Request`` are a placeholder
that no path runs, and are not ported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.api import Model


class ServeEngine:
    def __init__(self, model: Model, params: Any, *, batch_slots: int,
                 max_len: int):
        self.model = model
        self.params = params         # the model's module, e.g. a DecoderLM
        self.slots = batch_slots
        self.max_len = max_len

    def run_lockstep(self, prompts: list[list[int]], max_new: int
                     ) -> list[list[int]]:
        """Reference lock-step batch decode: all prompts the same length.
        Returns generated token lists."""
        B = len(prompts)
        if B > self.slots:
            raise ValueError(f"{B} prompts for {self.slots} slots")
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("lock-step needs prompts of equal length")
        if plen + max_new > self.max_len:
            raise ValueError(f"{plen} + {max_new} tokens exceed max_len "
                             f"{self.max_len}")
        toks = np.zeros((self.slots, 1), np.int64)
        outs: list[list[int]] = [[] for _ in range(B)]

        def step(index: int) -> np.ndarray:
            logits, _ = self.model.decode_step(
                self.params, cache, torch.from_numpy(toks), index)
            return logits[:, -1].argmax(dim=-1).cpu().numpy()

        cache = self.model.init_cache(self.slots, self.max_len)
        for t in range(plen):                       # prefill
            for b in range(B):
                toks[b, 0] = prompts[b][t]
            nxt = step(t)
        for s in range(max_new):                    # decode
            for b in range(B):
                outs[b].append(int(nxt[b]))
            toks[:, 0] = nxt
            nxt = step(plen + s)
        return outs
