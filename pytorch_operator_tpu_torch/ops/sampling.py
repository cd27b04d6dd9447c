"""Token sampling for the decode path (greedy / temperature / top-k /
nucleus) — the counterpart of ``pytorch_operator_tpu/ops/sampling.py``.

Same knobs, same validation and the same truncation semantics: top-k and
top-p mask off one shared descending sort, and nucleus composes on the
top-k-truncated distribution. Randomness comes from an explicit
``torch.Generator``; it cannot reproduce ``jax.random``'s bits, so tests
compare supports and the greedy limit, not sampled tokens.
"""

from __future__ import annotations

import torch


def validate_sampling(temperature: float, top_k: int, top_p: float) -> None:
    """The shared front-door checks (ValueError on bad knobs)."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} not in (0, 1]")
    if top_k < 0:
        raise ValueError(f"top_k={top_k} must be 0 (off) or >= 1")
    if temperature == 0.0 and (top_k > 0 or top_p < 1.0):
        # T=0 short-circuits to argmax; silently ignoring the knobs would
        # hand every row the identical greedy rollout.
        raise ValueError(
            "top_k/top_p require temperature > 0 (temperature=0 is greedy)"
        )


def make_sampler(temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0):
    """Build ``sample(logits [B, V], generator) -> tokens [B] int64``."""
    validate_sampling(temperature, top_k, top_p)

    def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        neg = torch.finfo(logits.dtype).min
        V = logits.shape[-1]
        if (0 < top_k < V) or top_p < 1.0:
            sorted_desc = torch.sort(logits, dim=-1, descending=True).values
            if 0 < top_k < V:
                # Keep the k highest logits (ties at the threshold survive).
                kth = sorted_desc[..., top_k - 1 : top_k]
                logits = logits.masked_fill(logits < kth, neg)
                rank = torch.arange(V, device=logits.device)
                sorted_desc = sorted_desc.masked_fill(rank >= top_k, neg)
            if top_p < 1.0:
                # Smallest token set whose cumulative probability reaches
                # top_p; the top token always survives (keep clamped to V-1:
                # the float cumsum may never reach a top_p near 1.0).
                cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
                keep = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=V - 1)
                cutoff = torch.gather(sorted_desc, -1, keep)
                logits = logits.masked_fill(logits < cutoff, neg)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator).squeeze(-1)

    return sample
