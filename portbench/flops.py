"""The yardstick's arithmetic: each kernel's operations and bytes from its
launch shapes, and a model's FLOPs from its configuration, by the counts of
its family's module (``portbench/families/<family>.py``).

Operations are the f32 product's: ``2 M N K`` for a matrix product and the
two attention products for attention, whatever number of bf16 term
products a kernel spends on them.  Bytes are each input read once and each
output written once.  Every size comes from the configuration file or from
a launch's shapes, never from the program's own counters.
"""
from __future__ import annotations

from . import spec

F32 = 4


# ------------------------------------------------------------- kernel 1

def matmul_work(batch: int, M: int, N: int, K: int, bias: bool = False):
    """``(flops, bytes)`` of ``batch`` f32 products (M, K) @ (K, N)."""
    flops = 2.0 * batch * M * N * K
    nbytes = F32 * batch * (M * K + K * N + M * N) + (F32 * N if bias else 0)
    return flops, float(nbytes)


# ------------------------------------------------------------- kernel 2

def causal_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head attends: queries at positions T - S ..
    T - 1 against keys 0 .. T - 1, causal and within ``window`` (0: any
    distance)."""
    if not causal:
        return S * T if window <= 0 else sum(min(T, window) for _ in range(S))
    total = 0
    if window <= 0:
        first = T - S + 1                   # keys seen by the first query
        return S * first + S * (S - 1) // 2
    for i in range(S):
        pos = T - S + i
        total += min(pos + 1, window)
    return total


def attention_work(B: int, S: int, T: int, H: int, Hkv: int, hd: int,
                   hdv: int, causal: bool = True, window: int = 0):
    """``(flops, bytes)`` of f32 attention: QK^T and P.V over the attended
    pairs; q, k, v read and the output written once."""
    pairs = causal_pairs(S, T, causal, window)
    flops = 2.0 * B * H * pairs * (hd + hdv)
    nbytes = F32 * B * (S * H * hd + T * Hkv * (hd + hdv) + S * H * hdv)
    return flops, float(nbytes)


# ------------------------------------------------------------- kernel 3

def paged_work(live: list, Hkv: int, rep: int, hd: int, hdv: int, ps: int,
               elem: int):
    """``(flops, bytes)`` of one paged decode-attention launch over the
    slots' attended lengths ``live`` (keys each, the new token's
    included): only the live pages are read, each once; q read and the
    output written in f32."""
    keys = sum(live)
    pages = sum(-(-n // ps) for n in live)
    flops = 2.0 * Hkv * rep * keys * (hd + hdv)
    nbytes = (pages * ps * Hkv * (hd + hdv) * elem
              + F32 * len(live) * Hkv * rep * (hd + hdv))
    return flops, float(nbytes)


# ----------------------------------------------------------- the model

def prefill_flops(conf: dict, prompt_len: int) -> float:
    """A prompt's forward: every prompt token through the stack, causal
    attention, and the one logit row the first token needs."""
    fam, P = spec.family(conf["family"]), prompt_len
    return (2.0 * fam.matmul_params(conf) * P
            + fam.attn_flops_per_pair(conf) * P * (P + 1) / 2
            + 2.0 * fam.logit_params(conf))


def decode_flops(conf: dict, attended: int) -> float:
    """One decode token attending ``attended`` keys (its own included)."""
    fam = spec.family(conf["family"])
    return (2.0 * fam.matmul_params(conf)
            + fam.attn_flops_per_pair(conf) * attended
            + 2.0 * fam.logit_params(conf))


def train_flops(conf: dict, batch: int, seq: int) -> float:
    """6 N D plus attention: forward and backward (three times the
    forward) of ``batch`` sequences of ``seq`` tokens, N the weights a
    token multiplies by (the unembedding included)."""
    fam = spec.family(conf["family"])
    n = fam.matmul_params(conf) + fam.logit_params(conf)
    tokens = batch * seq
    pair = fam.attn_flops_per_pair(conf)
    return 6.0 * n * tokens + 3.0 * pair * batch * seq * (seq + 1) / 2
