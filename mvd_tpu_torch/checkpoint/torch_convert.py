"""Reference (PyTorch Lightning / diffusers / transformers) weights -> the
JAX package's param tree, without flax.

Counterpart of ``mvd_tpu/checkpoint/torch_convert.py``: the same key remap
(the Lightning ``unet.`` prefix stripped, ``base_unet`` /
``camera_encoder`` / ``image_encoder`` groups, adapter processors at
``...attn{1,2}.processor.to_{q,k,v}_ref`` / ``to_out_ref.0``, dead reference
params reported and skipped) and the same layout transforms (conv OIHW ->
HWIO kernel, linear (O, I) -> (I, O) kernel, norm weight -> scale). The
output is the JAX converter's nested dict of numpy arrays, so
``checkpoint.from_jax.load_jax_params`` carries it into the port's modules.

The reference's camera-encoder translation projection is resampled every
forward, so its checkpoints hold no weight for it: ``load_checkpoint``
keeps the pipeline's init-time value for that leaf (and for any other leaf
a checkpoint lacks), and says so.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

from ..tensor_parallel import refuse_sharded
from .io import PARAMS_FILE, load_params_into

Flat = Dict[Tuple[str, ...], np.ndarray]


def flatten_tree(tree: Dict, prefix: Tuple[str, ...] = ()) -> Flat:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten_tree(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def unflatten_tree(flat: Flat) -> Dict:
    """{path tuple: leaf} -> nested dict."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


# diffusers UNet -> UNet2DCondition names
_UNET_BLOCK_RULES = [
    (r"^down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down_\1_resnet_\2."),
    (r"^down_blocks\.(\d+)\.attentions\.(\d+)\.", r"down_\1_attn_\2."),
    (r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"down_\1_downsample.conv."),
    (r"^up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up_\1_resnet_\2."),
    (r"^up_blocks\.(\d+)\.attentions\.(\d+)\.", r"up_\1_attn_\2."),
    (r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"up_\1_upsample.conv."),
    (r"^mid_block\.resnets\.(\d+)\.", r"mid_resnet_\1."),
    (r"^mid_block\.attentions\.(\d+)\.", r"mid_attn_\1."),
]
_INNER_RULES = [
    (r"\.transformer_blocks\.(\d+)\.", r".transformer_blocks_\1."),
    (r"\.attn1\.processor\.", r".adapter_self."),
    (r"\.attn2\.processor\.", r".adapter_cross."),
    (r"\.to_out_ref\.0\.", r".to_out_ref."),
    (r"\.to_out\.0\.", r".to_out."),
    (r"\.ff\.net\.0\.proj\.", r".ff.proj_geglu."),
    (r"\.ff\.net\.2\.", r".ff.proj_out."),
]


def _sub_all(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def _convert_tensor(parts: Tuple[str, ...], tensor) -> Tuple[str, np.ndarray]:
    """(flax leaf name, array in flax layout) of a torch ``.weight`` /
    ``.bias`` leaf."""
    leaf = parts[-1]
    tensor = np.asarray(tensor)
    if leaf == "weight":
        if tensor.ndim == 4:  # conv OIHW -> HWIO
            return "kernel", tensor.transpose(2, 3, 1, 0)
        if tensor.ndim == 2:
            return "kernel", tensor.T
        if tensor.ndim == 1:  # norm scale
            return "scale", tensor
    return leaf, tensor


def convert_unet_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[Dict, list]:
    """diffusers UNet2DConditionModel (+ adapter processors) state dict ->
    (UNet2DCondition param tree, [(key, reason) skipped])."""
    out: Flat = {}
    skipped = []
    for key, tensor in sd.items():
        # processor.ref_ln is dead code in the reference (attention.py:161 is
        # commented out) and its feature_adapter is always None
        if ".processor.ref_ln." in key or ".feature_adapter." in key:
            skipped.append((key, "dead reference param"))
            continue
        parts = tuple(_sub_all(_sub_all(key, _UNET_BLOCK_RULES), _INNER_RULES).split("."))
        leaf, val = _convert_tensor(parts, tensor)
        out[parts[:-1] + (leaf,)] = val
    return unflatten_tree(out), skipped


_CAM_SEQ_MAP_DEEP = {"0": "dense_0", "1": "ln_0", "3": "dense_1", "4": "ln_1", "6": "dense_out"}
_CAM_SEQ_MAP_SIMPLE = {"0": "dense_0", "1": "ln_0", "3": "dense_out"}
_CAM_FINAL_MAP = {"0": "final_dense_0", "1": "final_ln_0", "3": "final_dense_1", "4": "final_ln_1"}
_CAM_MOD_MAP = {"0": "dense_0", "1": "ln", "3": "dense_1"}


def convert_camera_encoder_state_dict(sd: Dict[str, np.ndarray], simple_encoder: bool = False) -> Dict:
    """Reference camera encoder -> CameraEncoder param tree. Keys of no known
    group (among them the absent translation projection's) are skipped."""
    seq_map = _CAM_SEQ_MAP_SIMPLE if simple_encoder else _CAM_SEQ_MAP_DEEP
    out: Flat = {}
    for key, tensor in sd.items():
        parts = key.split(".")
        leaf, val = _convert_tensor(tuple(parts), tensor)
        if parts[0] in ("rotation_encoder", "translation_encoder"):
            path = (parts[0], seq_map[parts[1]], leaf)
        elif parts[0] == "final_projection":
            path = (_CAM_FINAL_MAP[parts[1]], leaf)
        elif parts[0] == "output_norm":
            path = ("output_norm", leaf)
        elif parts[0] == "modulators":
            path = (f"mod_{parts[1]}_{_CAM_MOD_MAP[parts[2]]}", leaf)
        else:
            continue
        out[path] = val
    return unflatten_tree(out)


def convert_clip_text_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """transformers CLIPTextModel state dict -> CLIPTextEncoder param tree."""
    out: Flat = {}
    for key, tensor in sd.items():
        tensor = np.asarray(tensor)
        key = key.replace("text_model.", "")
        if key == "embeddings.token_embedding.weight":
            out[("token_embedding", "embedding")] = tensor
        elif key == "embeddings.position_embedding.weight":
            out[("position_embedding",)] = tensor
        elif re.match(r"encoder\.layers\.(\d+)\.", key):
            i, rest = re.match(r"encoder\.layers\.(\d+)\.(.*)", key).groups()
            parts = tuple(rest.replace("mlp.", "").split("."))
            leaf, val = _convert_tensor(parts, tensor)
            out[(f"layers_{i}",) + parts[:-1] + (leaf,)] = val
        elif key.startswith("final_layer_norm"):
            leaf, val = _convert_tensor(tuple(key.split(".")), tensor)
            out[("final_layer_norm", leaf)] = val
    return unflatten_tree(out)


_VAE_RULES = [
    (r"^(encoder)\.down_blocks\.(\d+)\.resnets\.(\d+)\.", r"\1.down_\2_resnet_\3."),
    (r"^(encoder)\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"\1.down_\2_downsample.conv."),
    (r"^(decoder)\.up_blocks\.(\d+)\.resnets\.(\d+)\.", r"\1.up_\2_resnet_\3."),
    (r"^(decoder)\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"\1.up_\2_upsample.conv."),
    (r"^(encoder|decoder)\.mid_block\.resnets\.(\d+)\.", r"\1.mid_resnet_\2."),
    (r"^(encoder|decoder)\.mid_block\.attentions\.0\.", r"\1.mid_attn."),
    (r"\.to_out\.0\.", r".to_out."),
]


def convert_vae_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """diffusers AutoencoderKL state dict -> AutoencoderKL param tree."""
    out: Flat = {}
    for key, tensor in sd.items():
        parts = tuple(_sub_all(key, _VAE_RULES).split("."))
        leaf, val = _convert_tensor(parts, tensor)
        parent = parts[-2] if len(parts) >= 2 else ""
        # older checkpoints hold the mid attention's q/k/v/out as 1x1 convs
        if val.ndim == 4 and val.shape[:2] == (1, 1) and parent.startswith("to_"):
            val = val[0, 0]
        out[parts[:-1] + (leaf,)] = val
    return unflatten_tree(out)


def split_lightning_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """The reference's key remap (infer.py:48-74): strip ``unet.`` and route
    the base_unet / camera_encoder / image_encoder groups."""
    groups = {"base_unet": {}, "camera_encoder": {}, "image_encoder": {}, "other": {}}
    for key, val in sd.items():
        k = key[len("unet."):] if key.startswith("unet.") else key
        for prefix, group in (("base_unet.", "base_unet"), ("camera_encoder.", "camera_encoder"),
                              ("image_encoder.unet.", "image_encoder"),
                              ("image_encoder.", "image_encoder")):
            if k.startswith(prefix):
                groups[group][k[len(prefix):]] = val
                break
        else:
            groups["other"][k] = val
    return groups


def convert_lightning_checkpoint(ckpt_path: str, simple_cam_encoder: bool = False,
                                 share_image_encoder: bool = True):
    """A Lightning ``.ckpt`` (``torch.load`` on the CPU) -> ({"params":
    {"unet": ..., "camera_encoder": ...[, "image_encoder_unet": ...]}},
    skipped)."""
    import torch

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    groups = split_lightning_state_dict(sd)
    unet_tree, skipped = convert_unet_state_dict(groups["base_unet"])
    params = {"unet": unet_tree}
    if groups["camera_encoder"]:
        params["camera_encoder"] = convert_camera_encoder_state_dict(
            groups["camera_encoder"], simple_cam_encoder)
    if groups["image_encoder"] and not share_image_encoder:
        params["image_encoder_unet"] = convert_unet_state_dict(groups["image_encoder"])[0]
    return {"params": params}, skipped


def zero_pad_conv_in(unet_params: Dict, extra_in_channels: int = 6) -> Dict:
    """A UNet param tree whose conv_in kernel takes ``extra_in_channels``
    more input channels, with zero weights: a checkpoint trained without
    ray-map conditioning gives the same outputs under it."""
    tree = dict(unet_params)
    conv = dict(tree["conv_in"])
    k = np.asarray(conv["kernel"])
    pad = np.zeros(k.shape[:2] + (extra_in_channels, k.shape[3]), k.dtype)
    conv["kernel"] = np.concatenate([k, pad], axis=2)
    tree["conv_in"] = conv
    return tree


_EXPORT_RULES = [
    (r"^down_(\d+)_resnet_(\d+)\.", r"down_blocks.\1.resnets.\2."),
    (r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2."),
    (r"^down_(\d+)_downsample\.conv\.", r"down_blocks.\1.downsamplers.0.conv."),
    (r"^up_(\d+)_resnet_(\d+)\.", r"up_blocks.\1.resnets.\2."),
    (r"^up_(\d+)_attn_(\d+)\.", r"up_blocks.\1.attentions.\2."),
    (r"^up_(\d+)_upsample\.conv\.", r"up_blocks.\1.upsamplers.0.conv."),
    (r"^mid_resnet_(\d+)\.", r"mid_block.resnets.\1."),
    (r"^mid_attn_(\d+)\.", r"mid_block.attentions.\1."),
    (r"\.transformer_blocks_(\d+)\.", r".transformer_blocks.\1."),
    (r"\.adapter_self\.", r".attn1.processor."),
    (r"\.adapter_cross\.", r".attn2.processor."),
    (r"\.GroupNorm_0\.", r"."),
    (r"\.ff\.proj_geglu\.", r".ff.net.0.proj."),
    (r"\.ff\.proj_out\.", r".ff.net.2."),
]


def export_unet_state_dict(unet_params: Dict) -> Dict[str, np.ndarray]:
    """UNet param tree -> diffusers-style state dict (numpy leaves)."""
    out = {}
    for path, val in flatten_tree(unet_params).items():
        key = _sub_all(".".join(str(p) for p in path), _EXPORT_RULES)
        val = np.asarray(val)
        stem, leaf = key.rsplit(".", 1)
        if leaf == "kernel":
            val = val.transpose(3, 2, 0, 1) if val.ndim == 4 else val.T
            key = stem + ".weight"
        elif leaf == "scale":
            key = stem + ".weight"
        for name in ("to_out", "to_out_ref"):  # torch ModuleList suffixes
            key = key.replace(f".{name}.weight", f".{name}.0.weight")
            key = key.replace(f".{name}.bias", f".{name}.0.bias")
        out[key] = val
    return out


def export_lightning_state_dict(mvd_params: Dict, simple_encoder: bool = False) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_lightning_checkpoint``: a multi-view UNet
    param tree ({"unet": ..., "camera_encoder": ...}) as the state dict of a
    reference Lightning checkpoint (``unet.base_unet.*``,
    ``unet.camera_encoder.*``). The translation projection has no reference
    weight and is left out."""
    out = {f"unet.base_unet.{k}": v for k, v in export_unet_state_dict(mvd_params["unet"]).items()}
    seq = {v: k for k, v in (_CAM_SEQ_MAP_SIMPLE if simple_encoder else _CAM_SEQ_MAP_DEEP).items()}
    final = {v: k for k, v in _CAM_FINAL_MAP.items()}
    mod = {v: k for k, v in _CAM_MOD_MAP.items()}
    for path, val in flatten_tree(mvd_params.get("camera_encoder", {})).items():
        *mods, leaf = path
        val = np.asarray(val)
        if leaf == "kernel":
            leaf, val = "weight", val.T
        elif leaf == "scale":
            leaf = "weight"
        if mods and mods[0] in ("rotation_encoder", "translation_encoder"):
            key = f"{mods[0]}.{seq[mods[1]]}"
        elif mods and mods[0] in final:
            key = f"final_projection.{final[mods[0]]}"
        elif mods == ["output_norm"]:
            key = "output_norm"
        elif mods and mods[0].startswith("mod_"):
            name, part = re.fullmatch(r"mod_(.+)_(dense_0|ln|dense_1)", mods[0]).groups()
            key = f"modulators.{name}.{mod[part]}"
        elif path == ("translation_projection",):
            continue
        else:
            raise KeyError(f"camera encoder leaf {'/'.join(path)} has no reference name")
        out[f"unet.camera_encoder.{key}.{leaf}"] = val
    return out


def load_checkpoint(pipe, path: str) -> Tuple[List[str], list]:
    """Load a directory written by the port's ``checkpoint.save_params``
    into ``pipe``, component by component (``io.load_params_into``; returns
    ([], [])), a directory the JAX package's ``save_params`` wrote with
    orbax of the whole pipeline tree (``mvd``, ``vae``, ``text_encoder``;
    every component loaded 1:1, a missing or extra component or leaf
    raises, as the JAX ``load_params(path, pipe.params)`` does; returns
    ([], [])), or a reference Lightning ``.ckpt`` into ``pipe``'s multi-view UNet
    (the UNet and the camera encoder; the VAE and CLIP keep their weights).
    Where the model holds a separate feature-pass UNet
    (``image_encoder_unet``, built with ``share_image_encoder=False``), the
    checkpoint's ``image_encoder`` group goes into it, and a checkpoint
    without that group raises; a model that shares its UNet does not read
    the group, as in the JAX converter.

    The converted tree is merged over the pipeline's masters: a parameter
    the checkpoint lacks (the camera encoder's translation projection, which
    the reference resamples every forward) keeps its init-time value and its
    name is printed; a converted leaf with no port parameter, or of another
    shape, raises. Under ray-map conditioning a 4-channel conv_in is zero
    padded to the 10 channels the ray model takes (output-preserving).
    Returns (names kept from init, [(key, reason)] skipped by the converter).
    Model-sharded networks raise: load first, then shard.
    """
    from .orbax_read import is_orbax_dir, read_metadata

    refuse_sharded(pipe.model, f"loading {path}")
    if os.path.isdir(path) and os.path.exists(os.path.join(path, PARAMS_FILE)):
        print(f"loaded {', '.join(load_params_into(pipe, path))} from {path}")
        return [], []
    if is_orbax_dir(path):
        comps = {str(m["key_metadata"][0]["key"]) for m in read_metadata(path)["tree_metadata"].values()}
        if comps != set(pipe.model):
            raise ValueError(f"{path}: the JAX package's save_params of components {sorted(comps)}; the "
                             f"pipeline's tree is {sorted(pipe.model)} (load a partial export with "
                             "--init-params)")
        print(f"loaded {', '.join(load_params_into(pipe, path))} from {path} (orbax)")
        return [], []
    if not path.endswith(".ckpt") or os.path.isdir(path):
        raise ValueError(
            f"{path}: the port loads a reference Lightning .ckpt or a directory written by "
            f"save_params (the port's, holding {PARAMS_FILE}, or the JAX package's orbax "
            "directory); this is neither")
    separate = hasattr(pipe.model["mvd"], "image_encoder_unet")
    cfg = pipe.config
    tree, skipped = convert_lightning_checkpoint(path, cfg.camera_encoder.simple_encoder,
                                                 share_image_encoder=not separate)
    params = dict(tree["params"])
    if separate and "image_encoder_unet" not in params:
        raise ValueError(f"{path} has no image_encoder group for the model's separate "
                         "image-encoder UNet")
    for unet in ("unet", "image_encoder_unet"):
        conv_in = params.get(unet, {}).get("conv_in", {}).get("kernel")
        if cfg.use_ray_conditioning and conv_in is not None and conv_in.shape[2] == cfg.unet.in_channels:
            params[unet] = zero_pad_conv_in(params[unet])
    kept = pipe.load_jax_params({"mvd": params}, keep_missing=True)
    for name in kept:
        print(f"checkpoint has no {name}: it keeps its initial value")
    if skipped:
        print(f"converter skipped {len(skipped)} dead reference params")
    return kept, skipped
