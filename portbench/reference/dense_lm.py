"""A plain PyTorch decoder-only LM of the Qwen2 / Qwen3 kind, in f32.

It reads the weights in the layout of ``portbench/weights.py`` (a norm's
weight is ``1 + scale``) and its sizes from the configuration file.  Every
product is a plain ``torch`` product; TF32 is switched off while it runs.
It imports nothing of the program.

Two options serve the comparisons of ``portbench/check.py``:

- ``bf16_cache_from``: the served cache is bf16.  Query rows from this
  position on attend to keys and values rounded to bf16, as a decode step
  over the bf16 page pool does; earlier rows (the prompt, which a prefill
  attends in f32) attend to the f32 keys and values.
- ``precision="bf16"``: every product takes bf16 operands (the control:
  the nearest precision below the f32 the configuration states).
"""
from __future__ import annotations

import contextlib
import math

import torch

BF16 = torch.bfloat16


@contextlib.contextmanager
def exact_f32():
    """Products in true f32: TF32 off for the extent."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _mm(a, b, precision):
    if precision == "bf16":
        return torch.matmul(a.to(BF16), b.to(BF16)).float()
    return torch.matmul(a, b)


def rmsnorm(x, scale, eps):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope(x, pos, theta):
    """Rotary embedding over the two halves of the head: x (S, H, d)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q, k, v, precision, q0=0):
    """Causal attention of queries at positions q0 .. q0 + S - 1 over keys
    0 .. T - 1: q (S, H, d), k and v (T, Hkv, d) -> (S, H, d)."""
    S, H, d = q.shape
    T, Hkv = k.shape[0], k.shape[1]
    rep = H // Hkv
    kk = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, T, d)
    vv = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    s = _mm(q.transpose(0, 1), kk.transpose(1, 2), precision) / math.sqrt(d)
    qpos = torch.arange(q0, q0 + S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _mm(p, vv, precision).transpose(0, 1)


def _layer(w, i, conf, precision):
    b = w["dense_blocks"]
    return ({k: t[i] for k, t in b["attn"].items()},
            {k: t[i] for k, t in b["mlp"].items()},
            b["ln1"][i], b["ln2"][i])


def _block(w, i, conf, x, pos, precision, bf16_from):
    """One layer over x (S, D) at positions ``pos``."""
    attn, mlp, ln1, ln2 = _layer(w, i, conf, precision)
    eps = conf["rms_norm_eps"]
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    Hkv, hd = conf["num_key_value_heads"], conf["head_dim"]
    S = x.shape[0]
    h = rmsnorm(x, ln1, eps)
    q = _mm(h, attn["wq"].reshape(D, H * hd), precision).view(S, H, hd)
    k = _mm(h, attn["wk"].reshape(D, Hkv * hd), precision).view(S, Hkv, hd)
    v = _mm(h, attn["wv"].reshape(D, Hkv * hd), precision).view(S, Hkv, hd)
    if conf["attention_bias"]:
        q, k, v = q + attn["bq"], k + attn["bk"], v + attn["bv"]
    if conf["qk_norm"]:
        q = rmsnorm(q, attn["q_norm"], eps)
        k = rmsnorm(k, attn["k_norm"], eps)
    q = rope(q, pos, conf["rope_theta"])
    k = rope(k, pos, conf["rope_theta"])
    if bf16_from is None or bf16_from >= S:
        o = _attend(q, k, v, precision)
    else:
        c = bf16_from
        o = torch.cat([
            _attend(q[:c], k[:c], v[:c], precision),
            _attend(q[c:], k.to(BF16).float(), v.to(BF16).float(), precision,
                    q0=c)])
    x = x + _mm(o.reshape(S, H * hd), attn["wo"].reshape(H * hd, D),
                precision)
    h = rmsnorm(x, ln2, eps)
    g = _mm(h, mlp["w_gate"], precision)
    u = _mm(h, mlp["w_up"], precision)
    return x + _mm(torch.nn.functional.silu(g) * u, mlp["w_down"], precision)


def unembedding(w, conf):
    V = conf["vocab_size"]
    if conf["tie_word_embeddings"]:
        return w["embed"][:V].T
    return w["unembed"][:, :V]


def logits(w, conf, tokens, rows, *, precision="f32", bf16_cache_from=None):
    """Logits (len(rows), vocab) at positions ``rows`` of one sequence
    ``tokens`` (1-D), its whole prefix run through every layer."""
    with exact_f32():
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        x = w["embed"][tokens.long()].float()
        for i in range(conf["num_hidden_layers"]):
            x = _block(w, i, conf, x, pos, precision, bf16_cache_from)
        x = rmsnorm(x[rows], w["ln_f"], conf["rms_norm_eps"])
        return _mm(x, unembedding(w, conf), precision)


def loss(w, conf, tokens, labels, z_loss, *, precision="f32"):
    """Summed next-token cross entropy plus ``z_loss`` logsumexp^2 over the
    rows of ``tokens`` (B, S), and the number of tokens."""
    total = torch.zeros((), device=tokens.device)
    for r in range(tokens.shape[0]):
        S = tokens.shape[1]
        pos = torch.arange(S, device=tokens.device)
        x = w["embed"][tokens[r].long()]
        for i in range(conf["num_hidden_layers"]):
            x = _block(w, i, conf, x, pos, precision, None)
        x = rmsnorm(x, w["ln_f"], conf["rms_norm_eps"])
        lg = _mm(x, unembedding(w, conf), precision)
        logz = torch.logsumexp(lg, -1)
        ll = lg.gather(-1, labels[r].long()[:, None])[:, 0]
        total = total + (logz - ll).sum() + z_loss * logz.square().sum()
    return total, tokens.numel()
