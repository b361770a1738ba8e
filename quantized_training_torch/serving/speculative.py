"""Speculative decoding: a small draft model proposes k tokens a round and
the target model checks them in ONE (k+1)-token forward.

With greedy sampling the accept rule is lossless: the emitted stream is
token for token the target's own greedy decode; a round emits 1..k+1
tokens for one target forward.  With a temperature the rejection rule
(``_spec_accept``) emits exactly the target's sampling distribution.

A round, as a host loop that reads the accepted count once:

1. draft: k+1 single-token steps through the draft's full-precision ring
   collect proposals d_1..d_k (the last step only writes d_k's K/V, so the
   draft ring holds exactly the tokens fed so far);
2. verify: the target takes ``[t_last, d_1..d_k]`` at its length p;
3. accept: m = the longest prefix of proposals the target agrees with; the
   emitted block is ``target_next[0..m]`` (greedy) or the accepted drafts
   and one resampled token;
4. rewind: the full-precision ring by its index (the next round writes
   from the new length and the mask hides the rest); a two-tier target
   (KIVI, int-sym or unquantized main) took the block in its residual
   ring via ``decode_append``, and nothing is promoted at decode, so
   lowering ``res_len`` by the k - m rejected slots undoes them.

B == 1 only: rows would accept different lengths.  The draft must use the
full-precision ring.
"""

from typing import Optional

import torch

from .generate import _categorical, _eos_mask, _sample, fast_argmax

__all__ = ["speculative_generate"]


def _accept_terms(p_logits, q_logits, x, temperature):
    """The rejection rule's two deterministic terms for proposals ``x``
    (..., ) drawn from softmax(q / T): log p(x) - log q(x), and the
    distribution a rejection resamples from, max(0, p - q) normalized (p
    itself where p == q everywhere).  p_logits/q_logits: (..., V)."""
    lp = torch.log_softmax(p_logits.float() / temperature, dim=-1)
    lq = torch.log_softmax(q_logits.float() / temperature, dim=-1)
    idx = x[..., None].long()
    log_ratio = (torch.gather(lp, -1, idx) - torch.gather(lq, -1, idx))[..., 0]
    resid = torch.clamp_min(lp.exp() - lq.exp(), 0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    probs = torch.where(norm > 0, resid / torch.clamp_min(norm, 1e-30),
                        lp.exp())
    return log_ratio, probs


def _spec_accept(p_logits, q_logits, x, generator, temperature):
    """The rejection-sampling accept rule (Leviathan et al., Chen et al.):
    accept the draft's ``x`` with probability min(1, p(x)/q(x)), else draw
    a replacement from the normalized residual max(0, p - q); the emitted
    marginal is exactly softmax(p / T).  p_logits/q_logits: (B, V) or
    (B, k, V); x: (B,) or (B, k).  Returns (accept, replacement)."""
    log_ratio, probs = _accept_terms(p_logits, q_logits, x, temperature)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    accept = torch.log(u) < log_ratio
    flat = torch.clamp_min(probs, 1e-38).reshape(-1, probs.shape[-1])
    repl = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return accept, repl.reshape(x.shape)


@torch.no_grad()
def speculative_generate(target_model, draft_model, input_ids: torch.Tensor,
                         max_new_tokens: int, *, k: int = 4,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         eos_token_id: Optional[int] = None,
                         return_stats: bool = False):
    """Speculative decoding; returns (1, S + max_new_tokens) tokens on the
    target's device (and with ``return_stats`` also {"rounds": n,
    "accept_rate": mean m / k}).

    ``temperature == 0``: greedy, token for token the target's own greedy
    decode.  ``temperature > 0``: rejection sampling, distributed exactly
    as the target's sampling at that temperature (no top-k).  The models
    share a vocab; the target may use the full-precision ring or a
    two-tier cache, the draft the full-precision ring; both live on one
    device.  ``generator`` draws every sample (a seeded one on that device
    by default).
    """
    B, S = input_ids.shape
    if B != 1:
        raise ValueError("speculative decoding is a latency path: B must "
                         f"be 1, got {B}")
    if draft_model.config.kv_cache is not None:
        raise ValueError("the draft model must use the full-precision cache")
    if max_new_tokens < 1 or k < 1:
        raise ValueError(f"max_new_tokens={max_new_tokens} and k={k} must "
                         "be at least 1")
    t_kcfg = target_model.config.kv_cache
    if t_kcfg is None:
        limit = target_model.config.max_position_embeddings
        if S + max_new_tokens + k + 1 > limit:
            raise ValueError(f"{S} + {max_new_tokens} + {k} + 1 positions "
                             f"exceed the target's ring ({limit})")
    else:
        if S > t_kcfg.max_prefill:
            raise ValueError(f"prompt of {S} tokens exceeds max_prefill="
                             f"{t_kcfg.max_prefill}")
        # every round may write k+1 residual slots before it rewinds
        if max_new_tokens + k > t_kcfg.max_decode:
            raise ValueError(f"max_new_tokens + k = {max_new_tokens + k} "
                             f"exceeds max_decode={t_kcfg.max_decode}")
    limit = draft_model.config.max_position_embeddings
    if S + max_new_tokens + k + 1 > limit:
        raise ValueError(f"{S} + {max_new_tokens} + {k} + 1 positions "
                         f"exceed the draft's ring ({limit})")

    device = target_model.device
    input_ids = input_ids.to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    greedy = temperature == 0.0

    # prefill both caches over the prompt (true length: only position -1
    # seeds the loop)
    logits, caches_t = target_model(
        input_ids, use_cache=True,
        prompt_len=S if t_kcfg is not None else None, last_logit_only=True)
    _, caches_d = draft_model(input_ids, use_cache=True,
                              last_logit_only=True)
    if greedy:
        t_last = fast_argmax(logits[:, -1])
    else:
        t_last = _sample(logits[:, -1], generator, temperature, None)

    out, count, rounds, accepted = [t_last[:, None]], 1, 0, 0
    while count < max_new_tokens:
        p = S + count - 1           # the target holds tokens 0..p-1
        tok, drafts, qlogits = t_last, [], []
        for j in range(k + 1):
            dlog, caches_d = draft_model(tok[:, None], use_cache=True,
                                         caches=caches_d, cache_index=p + j)
            if j == k:
                break               # this step only writes d_k's K/V
            dlog = dlog[:, -1]
            if greedy:
                tok = fast_argmax(dlog)
            else:
                tok = _categorical(dlog / temperature, generator)
                qlogits.append(dlog)
            drafts.append(tok)
        d = torch.stack(drafts, dim=1)                          # (1, k)
        logits, caches_t = target_model(
            torch.cat([t_last[:, None], d], dim=1), use_cache=True,
            caches=caches_t, cache_index=p, decode_append=True)
        if greedy:
            emit = fast_argmax(logits)                          # (1, k+1)
            agree = torch.cumprod((d == emit[:, :k]).to(torch.int32), dim=1)
            m = int(agree.sum())
        else:
            acc, repl = _spec_accept(logits[:, :k],
                                     torch.stack(qlogits, dim=1), d,
                                     generator, temperature)
            m = int(torch.cumprod(acc.to(torch.int32), dim=1).sum())
            # slot m: the residual draw where a proposal was rejected, else
            # a fresh draw from the target's last position
            final = (repl[:, m] if m < k else
                     _categorical(logits[:, k] / temperature, generator))
            emit = torch.cat([d[:, :m], final[:, None]], dim=1)
        if t_kcfg is not None and m < k:
            caches_t = [c._replace(res_len=c.res_len - (k - m))
                        for c in caches_t]
        out.append(emit[:, :m + 1])
        t_last = emit[:, m]
        count += m + 1
        rounds += 1
        accepted += m
    gen = torch.cat(out, dim=1)[:, :max_new_tokens].to(input_ids.dtype)
    if eos_token_id is not None:
        gen = _eos_mask(gen, eos_token_id)
    full = torch.cat([input_ids, gen], dim=1)
    if return_stats:
        return full, {"rounds": rounds,
                      "accept_rate": accepted / max(rounds * k, 1)}
    return full
