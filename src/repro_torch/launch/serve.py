"""Batched decode engine, the LM zoo's serving path (port of
``repro.launch.serve``): the encoder-decoder family, the dense / VLM
decoder-only family (a sliding-window config decodes through its ring
cache), the xLSTM family and the SSM / hybrid family (O(1) recurrent
state; zamba2's shared block also a KV cache per invocation).

Lockstep batched decoding, as in the reference:

* Requests are grouped into batches of ``max_batch`` by exact prompt
  length (the decode state keeps one position for the whole batch).
* One prefill call (``decode_step`` over the S prompt tokens, which fills
  the KV caches or runs the recurrences over the prompt; an enc-dec model
  first runs its encoder through ``prefill_encoder``), then
  token-by-token greedy (``argmax``) or temperature sampling
  (``torch.multinomial`` with the engine's own ``torch.Generator``);
  per-slot EOS tracking.
* The reference jits one step; PyTorch runs the step eagerly, under
  ``torch.inference_mode``.  Prefill and decode times are taken after
  ``torch.cuda.synchronize()`` on a card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.lm import ModelAPI, get_model

CACHE_MARGIN = 64                      # cache rows past prompt + new tokens


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early


@dataclasses.dataclass
class Completion:
    tokens: np.ndarray                 # [<=max_new_tokens]
    prefill_s: float
    decode_s: float
    steps: int


class ServeEngine:
    """Serves ``cfg`` with ``params`` (a dict of tensors on ``device``;
    None: the GPU, raising without one)."""

    def __init__(self, cfg: ArchConfig, params, max_batch: int = 8,
                 rng_seed: int = 0, temperature: float = 0.0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model: ModelAPI = get_model(cfg)
        self.params = params
        self.max_batch = max_batch
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)

    # ------------------------------------------------------------------
    def _step(self, tokens: torch.Tensor, state):
        logits, state = self.model.decode_step(self.params, tokens, state)
        if self.temperature > 0.0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32)[:, None], state

    def _init_state(self, batch: int, cache_len: int, enc_len: int = 0):
        if self.cfg.encoder_layers > 0:
            return self.model.decode_init(batch, cache_len, enc_len,
                                          device=self.device)
        if self.cfg.xlstm is not None:
            return self.model.decode_init(batch, device=self.device)
        return self.model.decode_init(batch, cache_len, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def generate_batch(self, requests: Sequence[Request],
                       frame_embeds: Optional[np.ndarray] = None
                       ) -> list[Completion]:
        """All requests must share a prompt length (exact-length batching)."""
        if not requests or len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests for max_batch "
                             f"{self.max_batch}")
        s = len(requests[0].prompt)
        if any(len(r.prompt) != s for r in requests):
            raise ValueError("exact-length batching: group requests by "
                             "prompt length")
        b = len(requests)
        max_new = max(r.max_new_tokens for r in requests)
        cache_len = s + max_new + CACHE_MARGIN
        dev = self.device

        with torch.inference_mode():
            enc_len = frame_embeds.shape[1] if frame_embeds is not None else 0
            state = self._init_state(b, cache_len, enc_len)
            if self.cfg.encoder_layers > 0:
                if frame_embeds is None:
                    raise ValueError("enc-dec serving needs frame_embeds")
                frames = torch.as_tensor(np.asarray(frame_embeds),
                                         device=dev)
                state["cross"] = encdec.prefill_encoder(self.params, self.cfg,
                                                        frames)
            prompts = torch.as_tensor(
                np.stack([r.prompt for r in requests]).astype(np.int32),
                device=dev)

            t0 = time.perf_counter()
            nxt, state = self._step(prompts, state)
            self._sync()
            prefill_s = time.perf_counter() - t0

            out = np.full((b, max_new), -1, np.int32)
            done = np.zeros(b, bool)
            steps = 0
            t0 = time.perf_counter()
            for i in range(max_new):
                cur = nxt[:, 0].cpu().numpy()
                for j, r in enumerate(requests):
                    if not done[j] and i < r.max_new_tokens:
                        out[j, i] = cur[j]
                        if cur[j] == r.eos_id or i + 1 >= r.max_new_tokens:
                            done[j] = True
                steps += 1
                if done.all():
                    break
                nxt, state = self._step(nxt, state)
            self._sync()
            decode_s = time.perf_counter() - t0

        comps = []
        for j, r in enumerate(requests):
            toks = out[j][out[j] >= 0][: r.max_new_tokens]
            comps.append(Completion(tokens=toks, prefill_s=prefill_s,
                                    decode_s=decode_s, steps=steps))
        return comps

    def serve(self, requests: Sequence[Request], **kw) -> list[Completion]:
        """Group by prompt length, batch up to max_batch, run rounds."""
        by_len: dict[int, list[Request]] = {}
        order: dict[int, list[int]] = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.prompt), []).append(r)
            order.setdefault(len(r.prompt), []).append(i)
        results: list[Optional[Completion]] = [None] * len(requests)
        for length, group in by_len.items():
            idxs = order[length]
            for lo in range(0, len(group), self.max_batch):
                chunk = group[lo:lo + self.max_batch]
                comps = self.generate_batch(chunk, **kw)
                for k_i, c in zip(idxs[lo:lo + self.max_batch], comps):
                    results[k_i] = c
        return results  # type: ignore[return-value]
