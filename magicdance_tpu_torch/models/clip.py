"""CLIP text towers (PyTorch).

`CLIPTextEncoder` is the counterpart of
`magicdance_tpu.models.clip.CLIPTextEncoder`: by default CLIP ViT-L/14, 12
pre-LN transformer layers, 12 heads, hidden 768, quick-GELU MLP (x4), causal
mask, learned position embeddings over 77 tokens, final LayerNorm; returns
last_hidden_state (B, 77, 768) in fp32. Its 77-token causal attention is
plain PyTorch math (fp32 logits and softmax), as it was plain XLA in JAX.
It computes in fp32 whatever dtype its weights are stored in (a trainer
keeps the frozen CLIP in bf16 or int8 storage). `encode_long_prompt` encodes prompts
longer than one window in windows.

The SDXL fields of `CLIPTextConfig` (the port's own) make the same module
an SDXL tower: exact GELU (OpenCLIP), the penultimate hidden state (the
input of the last layer, no final norm), and a pooled embedding (the final
LayerNorm at the EOT token times `text_projection`). `DualCLIPTextEncoder`
is SDXL's pair, CLIP ViT-L/14 (`tower_l`) and OpenCLIP ViT-bigG/14
(`tower_g`), in one module whose state dict is one network's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from magicdance_tpu_torch.config import CLIPTextConfig
from magicdance_tpu_torch.models.layers import Linear, layer_norm_f32
from magicdance_tpu_torch.models.quant import dequantize, param_at
from magicdance_tpu_torch.utils.profiling import span


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


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.layer_norm1 = nn.LayerNorm(c, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(c, eps=1e-5)
        self.fc1 = Linear(c, 4 * c)
        self.fc2 = Linear(4 * c, c)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x), causal_mask)
        h = self.fc2(self.act(self.fc1(layer_norm_f32(self.layer_norm2, x))))
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
        if cfg.output_layer not in ("last", "penultimate"):
            raise ValueError(f"unknown output_layer {cfg.output_layer!r}")
        self.cfg = cfg
        self.token_embedding = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        if cfg.projection_dim > 0:
            self.text_projection = nn.Parameter(torch.zeros(cfg.hidden_size,
                                                            cfg.projection_dim))

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (self.cfg.hidden_size,),
                            self.final_layer_norm.weight.float(),
                            self.final_layer_norm.bias.float(),
                            self.final_layer_norm.eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, S <= 77) int -> last_hidden_state (B, S, hidden) fp32
        (`output_layer` "penultimate": the last layer's input, no final norm)."""
        return self.encode(input_ids)[0]

    def encode(self, input_ids: torch.Tensor):
        """(hidden state as `forward` gives it, pooled (B, projection_dim)
        fp32 or None without a projection). A penultimate output without a
        projection leaves the last layer out: nothing reads it."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids.long()).float()
        x = x + param_at(self, "position_embedding", torch.float32)[None, :s]
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for i in range(cfg.num_layers - 1):
            x = getattr(self, f"layer_{i}")(x, causal[None, None])
        penultimate = cfg.output_layer == "penultimate"
        if penultimate and cfg.projection_dim == 0:
            return x, None
        last = self.final_norm(getattr(self, f"layer_{cfg.num_layers - 1}")(x, causal[None, None]))
        hidden = x if penultimate else last
        if cfg.projection_dim == 0:
            return hidden, None
        eot = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eot]
        return hidden, pooled @ param_at(self, "text_projection", torch.float32)


def repad(input_ids: torch.Tensor, cfg: CLIPTextConfig) -> torch.Tensor:
    """Ids padded as `cfg`'s tokenizer pads them: every position after the
    first EOS becomes `pad_token_id` (unchanged when it is None, EOS)."""
    if cfg.pad_token_id is None:
        return input_ids
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
    eot = (input_ids == cfg.eos_token_id).int().argmax(dim=1, keepdim=True)
    return torch.where(pos > eot, torch.full_like(input_ids, cfg.pad_token_id), input_ids)


class DualCLIPTextEncoder(nn.Module):
    """SDXL's two text towers (sd_xl_base.yaml's conditioner): CLIP ViT-L/14
    `tower_l` (hidden state 11 of 12) and OpenCLIP ViT-bigG/14 `tower_g`
    (penultimate, with the pooled projection). Both take the same CLIP-L
    ids (EOS-padded); each re-pads them as its own tokenizer does."""

    def __init__(self, cfg_l: CLIPTextConfig, cfg_g: CLIPTextConfig):
        super().__init__()
        if cfg_g.projection_dim == 0:
            raise ValueError("the second tower gives the pooled embedding: it needs a "
                             "projection_dim")
        self.tower_l = CLIPTextEncoder(cfg_l)
        self.tower_g = CLIPTextEncoder(cfg_g)

    def forward(self, input_ids: torch.Tensor):
        """input_ids (B, 77) -> (context (B, 77, l + g) fp32, the two
        towers' hidden states side by side; pooled (B, projection_dim) fp32)."""
        with span("md.clip tower=l"):
            h_l = self.tower_l(repad(input_ids, self.tower_l.cfg))
        with span("md.clip tower=g"):
            h_g, pooled = self.tower_g.encode(repad(input_ids, self.tower_g.cfg))
        return torch.cat([h_l, h_g], dim=-1), pooled


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
