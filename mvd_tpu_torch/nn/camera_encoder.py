"""Camera encoder + FiLM modulators (PyTorch).

Counterpart of ``mvd_tpu/nn/camera_encoder.py``: a rotation MLP over the
flattened relative rotation, a translation branch (positional encoding ->
fixed Gaussian projection ``translation_projection``, a parameter -> MLP), a
final projection, and per-block FiLM modulators returning the processed
``(scale, shift)``: scale = sigmoid(raw)*2*strength, shift = raw*strength.
Its LayerNorms are flax's, eps 1e-6, computed in f32. Model-sharded
(``parallel.shard_params_model_parallel``), every cut product and the
translation projection are gathered before their LayerNorm or FiLM split.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..camera import positional_encoding, relative_transform
from ..config import CameraEncoderConfig
from .layers import LayerNorm, Linear


def modulation_dims(block_out_channels, num_down, num_up) -> Dict[str, int]:
    """Modulator name -> channel dim."""
    down = list(block_out_channels)
    up = list(reversed(down))
    dims = {f"down_{i}": down[min(i, len(down) - 1)] for i in range(num_down)}
    dims.update({f"up_{i}": up[i] for i in range(num_up)})
    dims["mid"] = down[-1]
    dims["output"] = 4
    return dims


class _MLPBranch(nn.Module):
    """Linear(+LN+SiLU) stack ending in a plain Linear."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_hidden):
        super().__init__()
        self.num_hidden = num_hidden
        for i in range(num_hidden):
            setattr(self, f"dense_{i}", Linear(in_dim if i == 0 else hidden_dim, hidden_dim))
            setattr(self, f"ln_{i}", LayerNorm(hidden_dim))
        self.dense_out = Linear(hidden_dim, output_dim)

    def forward(self, x):
        for i in range(self.num_hidden):
            h = getattr(self, f"dense_{i}")(x)
            x = F.silu(getattr(self, f"ln_{i}")(h).to(h.dtype))
        return self.dense_out(x)


class CameraEncoder(nn.Module):
    def __init__(self, cfg: CameraEncoderConfig, modulation_hidden_dims: Sequence[Tuple[str, int]]):
        super().__init__()
        self.cfg = cfg
        self.modulation_hidden_dims = tuple(modulation_hidden_dims)
        n_hidden = 1 if cfg.simple_encoder else 2
        D = cfg.output_dim
        self.rotation_encoder = _MLPBranch(9, cfg.hidden_dim, D, n_hidden)
        t_dim = 3 * 2 * cfg.pos_enc_dim
        self.translation_projection = nn.Parameter(torch.empty(t_dim, D))
        self.translation_encoder = _MLPBranch(D, cfg.hidden_dim, D, n_hidden)
        self.final_dense_0 = Linear(2 * D, D)
        self.final_ln_0 = LayerNorm(D)
        self.final_dense_1 = Linear(D, D)
        self.final_ln_1 = LayerNorm(D)
        self.output_norm = LayerNorm(D)
        for name, dim in self.modulation_hidden_dims:
            setattr(self, f"mod_{name}_dense_0", Linear(D, D // 2))
            setattr(self, f"mod_{name}_ln", LayerNorm(D // 2))
            setattr(self, f"mod_{name}_dense_1", Linear(D // 2, dim * 2))

    def forward(self, source_camera: torch.Tensor, target_camera: torch.Tensor):
        """(B,4,4) cameras -> (camera_embedding (B, D), film dict)."""
        cfg = self.cfg
        dtype = self.final_dense_0.dtype
        R, T = relative_transform(source_camera.float(), target_camera.float())
        B = R.shape[0]
        r_emb = self.rotation_encoder(R.reshape(B, 9))
        t_enc = positional_encoding(T, cfg.pos_enc_dim, cfg.max_freq)
        proj = self.translation_projection
        t_enc = t_enc.to(dtype)
        t_enc = proj(t_enc) if isinstance(proj, nn.Module) else t_enc @ proj.to(dtype)
        t_emb = self.translation_encoder(t_enc)

        h = self.final_dense_0(torch.cat([r_emb, t_emb], dim=-1))
        h = F.silu(self.final_ln_0(h).to(dtype))
        h = self.final_ln_1(self.final_dense_1(h))
        emb = self.output_norm(h).to(dtype)

        film = {}
        for name, _ in self.modulation_hidden_dims:
            m = getattr(self, f"mod_{name}_dense_0")(emb)
            m = F.silu(getattr(self, f"mod_{name}_ln")(m).to(dtype))
            m = getattr(self, f"mod_{name}_dense_1")(m)
            raw_scale, raw_shift = m.chunk(2, dim=-1)
            scale = torch.sigmoid(raw_scale.float()) * 2.0 * cfg.modulation_strength
            shift = raw_shift.float() * cfg.modulation_strength
            film[name] = (scale, shift)
        return emb, film
