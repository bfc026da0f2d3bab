"""Load the metric towers from local torch state-dict files (no model zoo).

Counterpart of ``mvd_tpu/metrics/load_towers.py``, with the same arguments
and the same choice of towers: ``inception_weights`` gives the standard FID;
without it, ``with_fid`` and ``vgg_weights`` give FID-VGG; LPIPS-alex reads
its trunk from the ``net.``-prefixed keys of the lpips file, LPIPS-vgg takes
the VGG of ``vgg_weights``; a tower whose file is not named stays
unavailable and the harness skips it.

One deliberate difference: the JAX loader logs a warning and drops the
metric when a file the user named cannot be loaded, and gives ``with_fid``
without usable weights a silent FID without an extractor. Here both raise,
naming the file and its flag, so that no metric vanishes from a sweep
without an error. Files are read with ``torch.load(..., map_location="cpu",
weights_only=True)``; the towers move to the device of the images they
are given.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from .fid import FID, vgg_pool_extractor
from .inception import InceptionFIDExtractor, InceptionV3Features, inception_from_torch
from .towers import (
    LPIPS,
    LPIPS_ALEX_LAYERS,
    LPIPS_VGG_LAYERS,
    AlexNetFeatures,
    CLIPImageScore,
    CLIPVisionEncoder,
    PerceptualLoss,
    VGG16Features,
    _frozen,
    alexnet_from_lpips,
    clip_arch_from_sd,
    clip_vision_from_torch,
    lpips_lins_from_torch,
    vgg16_from_torch,
)


def _torch_load(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _load(flag: str, path: str, build: Callable[[Dict[str, torch.Tensor]], object]):
    """``build(state dict of path)``; any failure raises naming the flag
    and the file."""
    try:
        return build(_torch_load(path))
    except Exception as e:  # re-raised with the flag and the file named
        raise ValueError(f"{flag} {path!r} could not be loaded: {type(e).__name__}: {e}") from e


def _module(model: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """``model`` with ``sd`` loaded strictly (a missing or extra parameter
    raises), in eval mode without gradients."""
    model.load_state_dict(sd, strict=True)
    return _frozen(model)


def _lpips(sd: Dict[str, torch.Tensor], net: str, vgg: Optional[VGG16Features]) -> LPIPS:
    lins = lpips_lins_from_torch(sd, net)
    layers = LPIPS_ALEX_LAYERS if net == "alex" else LPIPS_VGG_LAYERS
    if sorted(lins) != sorted(layers):
        raise KeyError(f"the file holds learned weights for {sorted(lins)}, not {list(layers)}")
    if net == "vgg":
        if vgg is None:
            raise ValueError("LPIPS-vgg takes its trunk from --vgg-weights, which is not given")
        return LPIPS("vgg", vgg, lins)
    trunk = alexnet_from_lpips(sd)
    if not trunk:
        raise KeyError("no AlexNet trunk under net. (torchvision indices 0, 3, 6, 8, 10)")
    return LPIPS("alex", _module(AlexNetFeatures(), trunk), lins)


def _clip(sd: Dict[str, torch.Tensor]) -> CLIPImageScore:
    model = CLIPVisionEncoder(**clip_arch_from_sd(sd))  # H or L wiring from the shapes
    return CLIPImageScore(_module(model, clip_vision_from_torch(sd)))


def load_towers(
    vgg_weights: Optional[str] = None,
    lpips_weights: Optional[str] = None,
    lpips_net: str = "alex",
    clip_vision_weights: Optional[str] = None,
    inception_weights: Optional[str] = None,
    with_fid: bool = False,
) -> Dict:
    """The metric bank {"perceptual", "lpips", "clip", "fid"}; a tower
    without a weight file stays unavailable, a named file that cannot load
    raises, and ``with_fid`` without Inception or VGG weights raises."""
    towers: Dict = {}
    vgg = None
    if vgg_weights:
        vgg = _load("--vgg-weights", vgg_weights,
                    lambda sd: _module(VGG16Features(), vgg16_from_torch(sd)))
    towers["perceptual"] = PerceptualLoss(vgg)

    towers["lpips"] = LPIPS(lpips_net)
    if lpips_weights:
        towers["lpips"] = _load("--lpips-weights", lpips_weights, lambda sd: _lpips(sd, lpips_net, vgg))

    towers["clip"] = CLIPImageScore()
    if clip_vision_weights:
        towers["clip"] = _load("--clip-vision-weights", clip_vision_weights, _clip)

    if inception_weights:  # the standard Inception FID
        model = _load("--inception-weights", inception_weights,
                      lambda sd: _module(InceptionV3Features(), inception_from_torch(sd)))
        towers["fid"] = FID(InceptionFIDExtractor(model))
    elif with_fid:
        if vgg is None:
            raise ValueError("--fid needs --inception-weights (the standard FID) or "
                             "--vgg-weights (FID-VGG)")
        towers["fid"] = FID(vgg_pool_extractor(vgg))
    else:
        towers["fid"] = FID(None)
    return towers
