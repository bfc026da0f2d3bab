"""Pretrained-tower metrics: VGG16 perceptual, LPIPS, CLIP image score.

Counterpart of ``mvd_tpu/metrics/towers.py``, as ``nn.Module``s in NCHW:

  * VGG-16 perceptual loss: feature MSE of ``conv5_3`` (``features[:29]``,
    before its relu) after ImageNet normalisation of [-1, 1] images,
  * LPIPS (alex and vgg trunks): per-level features divided by
    ``sqrt(sum c² + 1e-10)`` (the epsilon inside the root, as the JAX
    package has it), squared difference, learned per-channel weights,
    spatial mean, sum over levels,
  * CLIP image-image score: 100 x the mean cosine similarity of the
    projected embeddings of two [0, 1] image batches.

Every tower takes NHWC images (a tensor on any device, or an array) and runs
on the device of the images it is given, in f32 with TF32 off for its own
convolutions and matmuls (``image.no_tf32``). The resize to a tower's input
size is bilinear with antialiasing, as ``jax.image.resize(..., "bilinear")``
is when it shrinks an image.

There is no model zoo: each tower is an architecture plus a converter from a
public state dict (torchvision ``vgg16``, the lpips package, transformers
``CLIPVisionModelWithProjection``); the parameters are named so that the
public keys map onto them one to one, and the public layouts are torch's
own (OIHW), so nothing is transposed. A metric object without weights is
``available`` False and the harness skips it. The CLIP attention is plain
``matmul`` + ``softmax`` through the port's text-tower ``CLIPLayer``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..nn.clip_text import CLIPLayer
from ..nn.layers import LayerNorm
from .image import no_tf32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# torchvision vgg16.features through conv5_3 (its last pool is not used)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512]
ALEX_CFG: List[Tuple[int, int, int, int]] = [  # (out_ch, kernel, stride, pad)
    (64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)
]


def _nchw(images) -> torch.Tensor:
    """NHWC images (tensor or array) as an f32 NCHW tensor on their device."""
    return torch.as_tensor(images).float().permute(0, 3, 1, 2)


def _chan(values: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, device=x.device).view(1, -1, 1, 1)


def _on(module: nn.Module, x: torch.Tensor) -> nn.Module:
    """``module`` on the device of ``x`` (moved there on first use)."""
    if next(module.parameters()).device != x.device:
        module.to(x.device)
    return module


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW to ``size`` x ``size``: half-pixel bilinear, antialiased when it
    shrinks, as ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def _imagenet_norm(x_m1_1: torch.Tensor) -> torch.Tensor:
    x01 = x_m1_1 * 0.5 + 0.5
    return (x01 - _chan(IMAGENET_MEAN, x01)) / _chan(IMAGENET_STD, x01)


def _frozen(module: nn.Module) -> nn.Module:
    return module.eval().requires_grad_(False)


class VGG16Features(nn.Module):
    """torchvision VGG16 ``features`` trunk (same indices) emitting every
    ``conv{b}_{i}`` map and its ``relu{b}_{i}``."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for c in VGG16_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU()]
                in_ch = c
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        block, in_block = 1, 1
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.MaxPool2d):
                block, in_block = block + 1, 1
            elif isinstance(layer, nn.Conv2d):
                feats[f"conv{block}_{in_block}"] = x
            else:
                feats[f"relu{block}_{in_block}"] = x
                in_block += 1
        return feats


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet ``features`` trunk (convs at indices 0, 3, 6, 8,
    10; a 3x3 stride-2 max pool after the first two), the LPIPS-alex
    backbone; emits ``relu_0`` ... ``relu_4``."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for i, (c, k, s, p) in enumerate(ALEX_CFG):
            layers += [nn.Conv2d(in_ch, c, k, stride=s, padding=p), nn.ReLU()]
            if i in (0, 1):
                layers.append(nn.MaxPool2d(3, 2))
            in_ch = c
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats, i = {}, 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                feats[f"relu_{i}"] = x
                i += 1
        return feats


class PerceptualLoss:
    """VGG-16 ``conv5_3`` feature MSE of two [-1, 1] image batches."""

    def __init__(self, model: Optional[VGG16Features] = None):
        self.model = model

    @property
    def available(self) -> bool:
        return self.model is not None

    def __call__(self, a_m1_1, b_m1_1) -> torch.Tensor:
        a, b = _nchw(a_m1_1), _nchw(b_m1_1)
        with torch.no_grad(), no_tf32():
            model = _on(self.model, a)
            fa = model(_imagenet_norm(a))["conv5_3"]
            fb = model(_imagenet_norm(b))["conv5_3"]
            return torch.mean((fa - fb) ** 2)


LPIPS_VGG_LAYERS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
LPIPS_ALEX_LAYERS = ("relu_0", "relu_1", "relu_2", "relu_3", "relu_4")
# LPIPS input scaling (Zhang et al. official implementation)
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS:
    """Learned perceptual distance of two [-1, 1] image batches; ``net`` is
    "alex" (an ``AlexNetFeatures`` backbone) or "vgg" (``VGG16Features``)."""

    def __init__(self, net: str = "alex", backbone: Optional[nn.Module] = None,
                 lin_weights: Optional[Mapping[str, torch.Tensor]] = None):
        self.net = net
        self.layers = LPIPS_ALEX_LAYERS if net == "alex" else LPIPS_VGG_LAYERS
        self.backbone = backbone
        self.lin_weights = lin_weights  # layer -> (C,) non-negative weights

    @property
    def available(self) -> bool:
        return self.backbone is not None and self.lin_weights is not None

    def _feats(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = (x - _chan(LPIPS_SHIFT, x)) / _chan(LPIPS_SCALE, x)
        return _on(self.backbone, x)(x)

    def __call__(self, a_m1_1, b_m1_1) -> torch.Tensor:
        a, b = _nchw(a_m1_1), _nchw(b_m1_1)
        with torch.no_grad(), no_tf32():
            fa, fb = self._feats(a), self._feats(b)
            total = 0.0
            for layer in self.layers:
                xa, xb = fa[layer], fb[layer]
                na = xa / torch.sqrt(torch.sum(xa**2, 1, keepdim=True) + 1e-10)
                nb = xb / torch.sqrt(torch.sum(xb**2, 1, keepdim=True) + 1e-10)
                w = torch.as_tensor(self.lin_weights[layer], device=a.device).view(1, -1, 1, 1)
                total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1))
            return total


# ---------------------------------------------------------------------------
# CLIP vision tower + image-image score
# ---------------------------------------------------------------------------


class CLIPVisionEncoder(nn.Module):
    """transformers ``CLIPVisionModelWithProjection``-compatible pre-LN ViT:
    patch conv without bias, class token, position embedding,
    ``pre_layernorm``, ``CLIPLayer``s under a zero mask, ``post_layernorm``
    of token 0 and ``visual_projection`` without bias. The defaults are
    OpenCLIP ViT-H/14; ``clip_arch_from_sd`` reads the architecture from a
    state dict."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 intermediate_size: int = 4096, patch_size: int = 14, image_size: int = 224,
                 projection_dim: int = 768, hidden_act: str = "gelu"):
        super().__init__()
        self.num_layers = num_layers
        self.image_size = image_size
        self.patch_embedding = nn.Conv2d(3, hidden_size, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(hidden_size))
        n_pos = 1 + (image_size // patch_size) ** 2
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, hidden_size))
        self.pre_layernorm = LayerNorm(hidden_size)
        cfg = CLIPTextConfig(hidden_size=hidden_size, num_layers=num_layers, num_heads=num_heads,
                             intermediate_size=intermediate_size, hidden_act=hidden_act)
        for i in range(num_layers):
            setattr(self, f"layers_{i}", CLIPLayer(cfg))
        self.post_layernorm = LayerNorm(hidden_size)
        self.visual_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, 3, H, W), CLIP-normalised -> projected embedding."""
        B = pixels.shape[0]
        seq = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, seq], dim=1) + self.position_embedding[None]
        x = self.pre_layernorm(x)
        mask = torch.zeros((1, 1, x.shape[1], x.shape[1]), device=x.device)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, mask)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


CLIP_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class CLIPImageScore:
    """Image-image cosine similarity x 100 of two [0, 1] image batches."""

    def __init__(self, model: Optional[CLIPVisionEncoder] = None):
        self.model = model

    @property
    def available(self) -> bool:
        return self.model is not None

    def embed(self, images01) -> torch.Tensor:
        x = _nchw(images01)
        with torch.no_grad(), no_tf32():
            x = resize_bilinear(x, self.model.image_size)
            x = (x - _chan(CLIP_PIXEL_MEAN, x)) / _chan(CLIP_PIXEL_STD, x)
            e = _on(self.model, x)(x)
            return e / torch.linalg.norm(e, dim=-1, keepdim=True)

    def __call__(self, a01, b01) -> torch.Tensor:
        ea, eb = self.embed(a01), self.embed(b01)
        return 100.0 * torch.mean(torch.sum(ea * eb, dim=-1))


# ---------------------------------------------------------------------------
# public state dicts -> the towers' parameters
# ---------------------------------------------------------------------------


def _conv_indices(cfg) -> List[int]:
    """torchvision ``features`` indices of the convs of a VGG config."""
    out, tv = [], 0
    for c in cfg:
        if c == "M":
            tv += 1
        else:
            out.append(tv)
            tv += 2  # conv + relu
    return out


def vgg16_from_torch(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 ``features.N.{weight,bias}`` (or ``N.*``) ->
    ``VGG16Features``; other keys (``classifier.*``) are ignored."""
    convs = set(_conv_indices(VGG16_CFG))
    out = {}
    for key, val in sd.items():
        m = re.match(r"(?:features\.)?(\d+)\.(weight|bias)$", key)
        if m and int(m.group(1)) in convs:
            out[f"features.{m.group(1)}.{m.group(2)}"] = val
    return out


ALEX_CONV_INDICES = (0, 3, 6, 8, 10)  # torchvision alexnet.features


def alexnet_from_lpips(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The AlexNet trunk of an lpips file (keys under ``net.``, torchvision
    indices 0, 3, 6, 8, 10, with or without ``features.``) ->
    ``AlexNetFeatures``."""
    out = {}
    for key, val in sd.items():
        m = re.match(r"net\.(?:features\.)?(\d+)\.(weight|bias)$", key)
        if m and int(m.group(1)) in ALEX_CONV_INDICES:
            out[f"features.{m.group(1)}.{m.group(2)}"] = val
    return out


def lpips_lins_from_torch(sd: Mapping[str, torch.Tensor], net: str = "alex") -> Dict[str, torch.Tensor]:
    """lpips package ``lin{i}.model.1.weight`` (1, C, 1, 1) -> layer -> (C,)."""
    layers = LPIPS_ALEX_LAYERS if net == "alex" else LPIPS_VGG_LAYERS
    out = {}
    for key, val in sd.items():
        m = re.match(r"lins?\.?(\d+)\.model\.1\.weight", key)
        if m and int(m.group(1)) < len(layers):
            out[layers[int(m.group(1))]] = torch.as_tensor(val).float().reshape(-1)
    return out


def clip_arch_from_sd(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The CLIP vision architecture of a transformers
    ``CLIPVisionModelWithProjection`` state dict, read from its shapes: the
    H family (width a multiple of 80) has 80-wide heads and exact GELU, the
    OpenAI B/L family 64-wide heads and ``quick_gelu``."""
    sd = {k.replace("vision_model.", ""): v for k, v in sd.items()}
    hidden = int(sd["embeddings.class_embedding"].shape[0])
    patch = int(sd["embeddings.patch_embedding.weight"].shape[2])
    num_pos = int(sd["embeddings.position_embedding.weight"].shape[0])
    layer_ids = [int(m.group(1)) for m in (re.match(r"encoder\.layers\.(\d+)\.", k) for k in sd) if m]
    fc1 = next(v for k, v in sd.items() if k.endswith("layers.0.mlp.fc1.weight"))
    h_family = hidden % 80 == 0
    return {
        "hidden_size": hidden,
        "num_layers": max(layer_ids) + 1,
        "num_heads": hidden // (80 if h_family else 64),
        "intermediate_size": int(fc1.shape[0]),
        "patch_size": patch,
        "image_size": patch * int(round((num_pos - 1) ** 0.5)),
        "projection_dim": int(sd["visual_projection.weight"].shape[0]),
        "hidden_act": "gelu" if h_family else "quick_gelu",
    }


def clip_vision_from_torch(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """transformers ``CLIPVisionModelWithProjection`` state dict ->
    ``CLIPVisionEncoder`` (``vision_model.`` dropped, ``embeddings.`` and
    the MLP's ``mlp.`` flattened, ``encoder.layers.N`` -> ``layers_N``);
    keys of no parameter (``position_ids``) are ignored."""
    out = {}
    for key, val in sd.items():
        k = key.replace("vision_model.", "")
        if k == "embeddings.class_embedding":
            out["class_embedding"] = val
        elif k == "embeddings.patch_embedding.weight":
            out["patch_embedding.weight"] = val
        elif k == "embeddings.position_embedding.weight":
            out["position_embedding"] = val
        elif k.startswith(("pre_layrnorm.", "pre_layernorm.")):
            out["pre_layernorm." + k.split(".", 1)[1]] = val
        elif k.startswith(("post_layernorm.", "visual_projection.")):
            out[k] = val
        else:
            m = re.match(r"encoder\.layers\.(\d+)\.(.*)", k)
            if m:
                out[f"layers_{m.group(1)}." + m.group(2).replace("mlp.", "")] = val
    return out
