"""CLIP text encoder (OpenCLIP ViT-H text tower as shipped with SD2.1).

Counterpart of ``mvd_tpu/nn/clip_text.py``: token + position embedding,
pre-LN causal transformer layers with exact-GELU (or quick_gelu) MLPs, and a
final LayerNorm; ``last_hidden_state`` (B, 77, hidden) in f32 is the UNet's
cross-attention context. Its 77-token causal attention is plain PyTorch, as
it is plain ``einsum`` in the JAX package. Model-sharded
(``parallel.shard_params_model_parallel``), each shard of q/k/v attends over
its own heads and ``fc1`` hands ``fc2`` its shards; the embeddings are
gathered.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..tensor_parallel import each
from .layers import LayerNorm, Linear


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        D = cfg.hidden_size
        self.head_dim = D // self.heads
        self.q_proj = Linear(D, D)
        self.k_proj = Linear(D, D)
        self.v_proj = Linear(D, D)
        self.out_proj = Linear(D, D)

    def forward(self, x, mask):
        B, S, _ = x.shape
        hd = self.head_dim

        def attend(q, k, v):  # the heads of q (a shard's, model-sharded)
            split = lambda t: t.reshape(B, S, t.shape[-1] // hd, hd).transpose(1, 2)
            q = split(q * hd**-0.5)
            k, v = split(k), split(v)
            logits = q.float() @ k.float().transpose(-1, -2) + mask
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            return (probs @ v).transpose(1, 2).reshape(B, S, -1)

        return self.out_proj(each(attend, self.q_proj(x), self.k_proj(x), self.v_proj(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.hidden_act = cfg.hidden_act
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x).to(x.dtype), mask)
        h = self.fc1(self.layer_norm2(x).to(x.dtype))
        if self.hidden_act == "quick_gelu":  # OpenAI CLIP: x * sigmoid(1.702 x)
            h = each(lambda h: h * torch.sigmoid(1.702 * h), h)
        else:  # exact GELU: the OpenCLIP ViT-H text tower of SD2.1
            h = each(F.gelu, h)
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(cfg))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, 77) int -> last_hidden_state (B, 77, hidden) f32."""
        B, S = input_ids.shape
        tok = self.token_embedding(input_ids.long())
        pos = self.position_embedding
        pos = pos() if isinstance(pos, nn.Module) else pos  # gathered, model-sharded
        x = tok + pos[None, :S].to(tok.dtype)
        causal = torch.triu(
            torch.full((S, S), -1e9, dtype=torch.float32, device=x.device), diagonal=1
        )
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, causal)
        return self.final_layer_norm(x)
