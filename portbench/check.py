"""The comparisons that decide ``correct``, against the plain reference
under ``portbench/reference/`` that the configuration's family module
names (``portbench/families/<family>.py``).  Each returns ``{name:
value}``; the cell's limits file (``portbench/limits/<cell>.json``) gives
each its limit.

Serving: the served tokens of a sample of finished requests, drawn from the
seed with the longest among them.  The reference runs each prompt with its
served tokens once; a served token's gap is how far its reference logit
lies below the reference's best at that position, and ``served_gap`` is
the widest.  Greedy tokens only, which the mixes serve.

Training: the first three steps of the timed step, against the reference
following them from the same weights and batches.  ``loss_gap``: the
largest relative gap of a step's loss.  ``grad1_gap``: the first gradient
as the optimizer takes it (its first moment over ``1 - b1``), by the worst
leaf, the gap of the norms against the larger of the reference leaf's norm
and the median leaf's.  ``change_gap``: each leaf's change over the three
steps, likewise, over the leaves whose reference gradient is at least a
thousandth of the median leaf's (a gradient nought to rounding moves its
leaf under Adam by round-off alone).
"""
from __future__ import annotations

import numpy as np
import torch

from . import spec


def sample_finished(sent: list, seed: int, want_tokens: int,
                    most: int) -> list:
    """The finished requests to compare: the one with the most served
    tokens, then others drawn from the seed, until ``want_tokens`` served
    tokens or ``most`` requests."""
    done = [s for s in sent if s.tokens]
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.tokens), -s.rid))
    rest = [s for s in done if s is not longest]
    order = np.random.default_rng([seed % (2 ** 64), 7]).permutation(
        len(rest))
    pick, n = [longest], len(longest.tokens)
    for i in order:
        if n >= want_tokens or len(pick) >= most:
            break
        pick.append(rest[i])
        n += len(rest[i].tokens)
    return pick


def _rows(prompt, tokens, device):
    P = len(prompt)
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]),
                          dtype=torch.long, device=device)
    rows = torch.arange(P - 1, P - 1 + len(tokens), device=device)
    tok = torch.as_tensor(tokens, dtype=torch.long, device=device)
    return seq, rows, tok, P


def served_gap(w, conf, samples, device) -> float:
    """The widest gap of a served token below the reference's best."""
    logits, worst = spec.family(conf["family"]).logits, 0.0
    for prompt, tokens in samples:
        seq, rows, tok, P = _rows(prompt, tokens, device)
        ref = logits(w, conf, seq, rows, bf16_cache_from=P)
        gap = ref.max(-1).values - ref.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def control_gap(w, conf, samples, device) -> float:
    """The control: at the same positions, the gap of the token that the
    reference computed in bf16 puts first."""
    logits, worst = spec.family(conf["family"]).logits, 0.0
    for prompt, tokens in samples:
        seq, rows, tok, P = _rows(prompt, tokens, device)
        ref = logits(w, conf, seq, rows, bf16_cache_from=P)
        low = logits(w, conf, seq, rows, bf16_cache_from=P, precision="bf16")
        pick = low.argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def _leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    keys = [k for k in ref if keep is None or keep(k)]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses``, ``grad1``, ``change`` (per-leaf
    norms); ``ref`` also ``grad1_raw``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med = float(np.median(list(ref["grad1_raw"].values())))
    moves = (lambda k: ref["grad1_raw"][k] >= 1e-3 * med)
    return {"loss_gap": loss,
            "grad1_gap": _leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moves)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every one is within."""
    out, ok = {}, True
    for k, v in values.items():
        lim = limits[k]
        good = v is not None and np.isfinite(v) and v <= lim
        ok = ok and bool(good)
        out[k] = {"value": v, "limit": lim}
    return ok, out
