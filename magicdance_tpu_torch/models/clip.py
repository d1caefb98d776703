"""CLIP ViT-L/14 text tower (PyTorch).

Counterpart of `magicdance_tpu.models.clip.CLIPTextEncoder`: 12 pre-LN
transformer layers, 12 heads, hidden 768, quick-GELU MLP (x4), causal mask,
learned position embeddings over 77 tokens, final LayerNorm; returns
last_hidden_state (B, 77, 768) in fp32. Its 77-token causal attention is
plain PyTorch math (fp32 logits and softmax), as it was plain XLA in JAX.
It computes in fp32 whatever dtype its weights are stored in (a trainer
keeps the frozen CLIP in bf16 or int8 storage). `encode_long_prompt` encodes prompts
longer than one window in windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import CLIPTextConfig
from magicdance_tpu_torch.models.layers import Linear, layer_norm_f32
from magicdance_tpu_torch.models.quant import dequantize, param_at


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        c = cfg.hidden_size
        self.q_proj = Linear(c, c)
        self.k_proj = Linear(c, c)
        self.v_proj = Linear(c, c)
        self.out_proj = Linear(c, c)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.num_heads

        def split(t):
            return t.reshape(b, s, self.num_heads, hd)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits * (hd ** -0.5) + causal_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(out.reshape(b, s, c))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.fc1 = Linear(c, 4 * c)
        self.fc2 = Linear(4 * c, c)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x), causal_mask)
        h = self.fc2(quick_gelu(self.fc1(layer_norm_f32(self.layer_norm2, x))))
        return x + h


class Embedding(nn.Embedding):
    """nn.Embedding whose table may be held in int8 (`models.quant`): the rows
    are gathered, then dequantized with the per-channel scale (the values of
    dequantizing the whole table first, as JAX does)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype != torch.int8:
            return super().forward(ids)
        return dequantize(F.embedding(ids, self.weight), self.weight_scale)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S <= 77) int -> last_hidden_state (B, S, hidden) fp32."""
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids.long()).float()
        x = x + param_at(self, "position_embedding", torch.float32)[None, :s]
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal[None, None])
        return F.layer_norm(x.float(), (self.cfg.hidden_size,),
                            self.final_layer_norm.weight.float(),
                            self.final_layer_norm.bias.float(),
                            self.final_layer_norm.eps)


def encode_long_prompt(encoder: CLIPTextEncoder, token_ids: torch.Tensor,
                       windows: int = 3) -> torch.Tensor:
    """Prompts longer than the encoder's window, encoded in windows: the raw
    ids are cut (or padded with EOS) to `windows` chunks of max_length - 2
    tokens, each chunk wrapped in BOS/EOS and encoded alone, and the hidden
    states concatenated along the sequence (ref cldm/hack.py:32).

    token_ids: (B, n) raw BPE ids without BOS/EOS. Returns
    (B, windows * max_length, hidden) fp32."""
    cfg = encoder.cfg
    body = cfg.max_length - 2
    b, n = token_ids.shape
    total = windows * body
    pad = torch.full((b, max(0, total - n)), cfg.eos_token_id, dtype=token_ids.dtype,
                     device=token_ids.device)
    ids = torch.cat([token_ids[:, :total], pad], dim=1)
    bos = torch.full((b, 1), cfg.bos_token_id, dtype=ids.dtype, device=ids.device)
    eos = torch.full((b, 1), cfg.eos_token_id, dtype=ids.dtype, device=ids.device)
    return torch.cat([encoder(torch.cat([bos, ids[:, w * body:(w + 1) * body], eos], dim=1))
                      for w in range(windows)], dim=1)
