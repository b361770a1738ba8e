"""Continuous batching engine (iteration-level scheduling) over the
quantized KV cache.

A fixed number of batch slots decode in lockstep, one model call per step;
when a request finishes (EOS, token budget or a stop sequence) its slot is
refilled from the queue by prefilling the new request alone and writing
its quantized cache into that slot -- the other slots keep decoding,
tracked by per-slot (B,) main / residual lengths (serving/kv_cache.py).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .generate import _sample, sample_batch
from .kv_cache import KVCacheConfig, init_cache

__all__ = ["ContinuousBatchingEngine", "SamplingParams"]


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling overrides.  ``temperature`` 0 = greedy;
    ``top_k`` 0 = disabled; ``top_p`` 1.0 = disabled.  ``stop``: token-id
    sequences that end the request (matched on the generated tail and
    trimmed from the output)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: Tuple[Tuple[int, ...], ...] = ()


@dataclass
class _Slot:
    request_id: Optional[int] = None
    prompt_len: int = 0
    generated: List[int] = field(default_factory=list)
    budget: int = 0
    params: SamplingParams = field(default_factory=SamplingParams)


class ContinuousBatchingEngine:
    """Slot-synchronous continuous batching for a model with a quantized KV
    cache (``model.config.kv_cache``), on the model's device (CUDA unless
    the model was built on the CPU)."""

    def __init__(self, model, *, batch_slots: int = 8,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 max_top_k: int = 64):
        if model.config.kv_cache is None:
            raise ValueError("ContinuousBatchingEngine needs a model with a "
                             "quantized KV cache (config.kv_cache)")
        self.model = model
        self.device = model.device
        self.kcfg: KVCacheConfig = model.config.kv_cache
        self.B = batch_slots
        self.eos = eos_token_id
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.max_top_k = max_top_k
        self.caches = None           # one per-slot QuantizedKVCache per layer
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: List[Tuple[int, np.ndarray, int, SamplingParams]] = []
        self.finished: Dict[int, List[int]] = {}
        self._next_id = 0
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                  device=self.device)
        # Prefill length buckets: a short prompt pads only to the smallest
        # bucket >= its length; the stored cache is the same for any pad
        # length (prefill_cache pads and masks to max_prefill itself).
        P = self.kcfg.max_prefill
        if prefill_buckets is None:
            prefill_buckets = sorted({min(P, max(32, P // 4)),
                                      min(P, max(32, P // 2)), P})
        if not all(1 <= b <= P for b in prefill_buckets):
            raise ValueError(f"prefill buckets {prefill_buckets} must lie in "
                             f"[1, max_prefill={P}]")
        self.prefill_buckets = sorted(set(prefill_buckets) | {P})
        # per-slot sampling only when some request is not greedy
        self._dynamic_sampling = (self.temperature != 0.0
                                  or top_k is not None or top_p is not None)

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               stop: Optional[List[List[int]]] = None) -> int:
        """Queue a request.  Sampling kwargs override the engine defaults for
        this request only; ``stop`` is a list of token-id sequences that end
        the request (trimmed from the returned tokens)."""
        rid = self._next_id
        self._next_id += 1
        params = SamplingParams(
            temperature=self.temperature if temperature is None
            else float(temperature),
            top_k=(self.top_k or 0) if top_k is None else int(top_k),
            top_p=(1.0 if self.top_p is None else self.top_p)
            if top_p is None else float(top_p),
            stop=tuple(tuple(int(t) for t in s) for s in (stop or ())),
        )
        if params.temperature != 0.0:
            self._dynamic_sampling = True
        self.queue.append((rid, np.asarray(prompt_ids).reshape(-1),
                           max_new_tokens, params))
        return rid

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns {request_id: generated tokens}."""
        while self.queue or any(s.request_id is not None for s in self.slots):
            self._fill_slots()
            self.step()
        out, self.finished = self.finished, {}
        return out

    # ------------------------------------------------------------ internals
    def _init_caches(self):
        cfg = self.model.config
        lens = torch.zeros((self.B,), dtype=torch.int32, device=self.device)
        self.caches = [
            init_cache(self.kcfg, self.B, cfg.kv_heads, cfg.head_dim,
                       cfg.torch_dtype, device=self.device
                       )._replace(main_len=lens.clone(), res_len=lens.clone())
            for _ in range(cfg.num_hidden_layers)]

    def _fill_slots(self):
        for b, slot in enumerate(self.slots):
            if slot.request_id is None and self.queue:
                rid, ids, budget, params = self.queue.pop(0)
                slot.request_id = rid
                slot.prompt_len = len(ids)
                slot.budget = budget
                slot.params = params
                # prefill seeds slot.generated with the first sampled token
                self._prefill_slot(b, ids)

    def _prefill_slot(self, b: int, ids: np.ndarray):
        if self.caches is None:
            self._init_caches()
        P = self.kcfg.max_prefill
        ids = ids[-P:]
        S = len(ids)
        bucket = next(bk for bk in self.prefill_buckets if bk >= S)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :S] = torch.as_tensor(ids, dtype=torch.int64)
        logits, small = self.model(padded.to(self.device), use_cache=True,
                                   prompt_len=S)
        # write the prefilled slot into the batched caches, in place (the
        # per-token symmetric cache's (1,) zero-point placeholders are
        # shared by every slot)
        for big, one in zip(self.caches, small):
            for name in big._fields[:-2]:
                buf = getattr(big, name)
                if buf.dim() > 1:
                    buf[b].copy_(getattr(one, name)[0])
            big.main_len[b] = one.main_len
            big.res_len[b] = 0
        # last *real* token's logits, sampled with this request's params
        pr = self.slots[b].params
        next_tok = int(_sample(
            logits[0, S - 1][None], self.generator, pr.temperature,
            pr.top_k or None, pr.top_p if pr.top_p < 1.0 else None)[0])
        self.tokens[b, 0] = next_tok
        self.slots[b].generated = [next_tok]

    def _slot_sampling_tensors(self):
        temp = np.zeros(self.B, np.float32)
        topk = np.zeros(self.B, np.int64)
        topp = np.ones(self.B, np.float32)
        for b, slot in enumerate(self.slots):
            if slot.request_id is not None:
                temp[b] = slot.params.temperature
                topk[b] = slot.params.top_k
                topp[b] = slot.params.top_p
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (temp, topk, topp))

    @torch.no_grad()
    def step(self):
        if self.caches is None:
            return
        first = self.caches[0]
        positions = (first.main_len + first.res_len)[:, None].to(torch.int64)
        logits, self.caches = self.model(
            self.tokens, positions=positions, use_cache=True,
            caches=self.caches)
        if self._dynamic_sampling:
            # per-slot params (temperature 0 rows stay greedy)
            nxt = sample_batch(logits[:, -1], self.generator,
                               *self._slot_sampling_tensors(),
                               max_top_k=self.max_top_k)
        else:
            nxt = _sample(logits[:, -1], self.generator, self.temperature,
                          self.top_k, self.top_p)
        self.tokens = nxt[:, None].to(torch.int64)
        nxt_host = nxt.tolist()
        for b, slot in enumerate(self.slots):
            if slot.request_id is None:
                continue
            tok = int(nxt_host[b])
            slot.generated.append(tok)
            done = (self.eos is not None and tok == self.eos) or \
                len(slot.generated) >= slot.budget or \
                len(slot.generated) >= self.kcfg.max_decode
            for seq in slot.params.stop:
                L = len(seq)
                if L and len(slot.generated) >= L and \
                        tuple(slot.generated[-L:]) == seq:
                    slot.generated = slot.generated[:-L]  # trim the stop
                    done = True
                    break
            if done:
                self.finished[slot.request_id] = slot.generated
                slot.request_id = None
