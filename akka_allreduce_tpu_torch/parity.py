"""The decode-parity rule: when two greedy token streams must agree.

Two implementations of one model compute logits that differ by rounding
(another summation order, another kernel). Greedy decode then picks the
same token wherever the reference's top-2 logit gap is wider than that
noise; where the gap is narrower the pick is a coin toss, and after the
first such disagreement the two streams continue from different
prefixes and are no longer comparable. So: compare token by token, stop
at the first disagreement, and accept it only where the reference's gap
was at most ``min_gap``.
"""

from __future__ import annotations

import numpy as np


def top2_gap(logits) -> np.ndarray:
    """(..., vocab) logits -> (...,) gap between the two largest."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]


def greedy_agree(ref_tokens, got_tokens, ref_logits,
                 min_gap: float = 1e-3) -> "tuple[bool, str]":
    """Check one request's greedy stream ``got_tokens`` against
    ``ref_tokens``. ``ref_logits[i]`` (vocab,) are the reference's logits
    that picked ``ref_tokens[i]``. Returns ``(ok, reason)``: ok when the
    streams agree up to the first disagreement, that disagreement (if
    any) falls where the reference's top-2 gap is <= ``min_gap``, and a
    length difference (an EOS picked differently) likewise sits at a
    narrow-gap step."""
    ref = [int(t) for t in ref_tokens]
    got = [int(t) for t in got_tokens]
    gaps = top2_gap(np.asarray(ref_logits)[:len(ref)])
    for i in range(min(len(ref), len(got))):
        if ref[i] != got[i]:
            if gaps[i] <= min_gap:
                return True, f"diverged at step {i} (gap {gaps[i]:.2e})"
            return False, (f"token {i}: {got[i]} != {ref[i]} with a top-2 "
                           f"gap of {gaps[i]:.2e} > {min_gap}")
    if len(ref) != len(got):
        i = min(len(ref), len(got)) - 1
        if i >= 0 and gaps[i] <= min_gap:
            return True, f"length differs after a narrow gap at step {i}"
        return False, f"lengths {len(got)} != {len(ref)}"
    return True, "identical"
