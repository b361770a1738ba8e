"""Evaluation protocols (reference: utils/evaluation.py): WikiText
perplexity over max_length-1024 / stride-512 sliding windows (reference:
examples/language_modeling/wikitext.py:138-172, README.md:96-97).  The
SQuAD metrics are not ported yet."""

from typing import Callable, List

import numpy as np
import torch

from . import resolve_device

__all__ = ["sliding_window_perplexity"]


@torch.no_grad()
def sliding_window_perplexity(
    forward: Callable[[torch.Tensor], torch.Tensor],
    token_ids,
    max_length: int = 1024,
    stride: int = 512,
    pad_token_id: int = 0,
    *,
    device="cuda",
) -> float:
    """Perplexity of one long token stream over overlapping windows.

    The reference's protocol exactly: window starts are ``range(0, seq_len
    - max_length, stride)``, so every window holds ``max_length`` tokens;
    of each window only the last ``trg_len = end - prev_end`` targets count
    (the -100 masking); each window's mean NLL is kept, and the perplexity
    is exp(mean of the window means).  Tokens after the last full window
    are never read, as in the reference.  A stream no longer than one
    window is read as one truncated window.  ``pad_token_id`` is unused
    (windows are real tokens, never padded).

    ``forward`` maps a (1, L) int64 tensor on ``device`` to (1, L, vocab)
    logits there; the log-softmax runs on the device in float32 and only
    the window's NLLs come back to the host."""
    del pad_token_id
    device = resolve_device(device)
    ids = torch.as_tensor(np.asarray(token_ids).reshape(-1),
                          dtype=torch.long)
    seq_len = ids.shape[0]
    begins = list(range(0, seq_len - max_length, stride)) or [0]
    window_nlls: List[np.floating] = []
    prev_end = 0
    for begin in begins:
        end = min(begin + max_length, seq_len)
        trg_len = end - prev_end
        window = ids[begin:end].to(device)
        logits = forward(window[None])[0]
        # next-token NLL: a window of L tokens has L - 1 loss terms
        logp = torch.log_softmax(logits[:-1].to(torch.float32), dim=-1)
        nll = -logp.gather(-1, window[1:, None])[:, 0]
        n_valid = min(trg_len, window.shape[0] - 1)
        window_nlls.append(nll[-n_valid:].cpu().numpy().mean())
        prev_end = end
    return float(np.exp(np.mean(window_nlls)))
