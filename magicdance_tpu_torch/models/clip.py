"""CLIP ViT-L/14 text tower (PyTorch).

Counterpart of `magicdance_tpu.models.clip.CLIPTextEncoder`: 12 pre-LN
transformer layers, 12 heads, hidden 768, quick-GELU MLP (x4), causal mask,
learned position embeddings over 77 tokens, final LayerNorm; returns
last_hidden_state (B, 77, 768) in fp32. Its 77-token causal attention is
plain PyTorch math (fp32 logits and softmax), as it was plain XLA in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import CLIPTextConfig
from magicdance_tpu_torch.models.layers import layer_norm_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

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
        self.fc1 = nn.Linear(c, 4 * c)
        self.fc2 = nn.Linear(4 * c, c)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x), causal_mask)
        h = self.fc2(quick_gelu(self.fc1(layer_norm_f32(self.layer_norm2, x))))
        return x + h


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S <= 77) int -> last_hidden_state (B, S, hidden) fp32."""
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids.long())
        x = x + self.position_embedding[None, :s].to(x.dtype)
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal[None, None])
        return F.layer_norm(x.float(), (self.cfg.hidden_size,),
                            self.final_layer_norm.weight.float(),
                            self.final_layer_norm.bias.float(),
                            self.final_layer_norm.eps)
