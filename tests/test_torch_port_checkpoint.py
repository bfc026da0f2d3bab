"""The port's reference-checkpoint converter against the JAX package's.

A synthetic Lightning ``.ckpt`` (random tensors under the reference's key
names: the multi-view UNet from the JAX package's own export, the camera
encoder, a dead ``ref_ln`` param) and diffusers-named CLIP and VAE state
dicts go through ``mvd_tpu.checkpoint.torch_convert`` and through the
port's ``checkpoint/torch_convert.py``: the trees, and the parameters they
load into the port's modules, must be bitwise equal. No weights are
fetched; TINY_MODEL is cut in depth (``cut_config``) as in the other port
tests.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_port_util import cut_config, random_params
from mvd_tpu.checkpoint import torch_convert as jconv
from mvd_tpu.config import TINY_MODEL as J_TINY
from mvd_tpu.nn import MultiViewUNet as JMVD
from mvd_tpu_torch.checkpoint import (
    convert_clip_text_state_dict,
    convert_jax_params,
    convert_lightning_checkpoint,
    convert_unet_state_dict,
    convert_vae_state_dict,
    export_jax_params,
    export_lightning_state_dict,
    export_unet_state_dict,
    load_checkpoint,
    load_jax_params,
    split_lightning_state_dict,
    zero_pad_conv_in,
)
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.nn import AutoencoderKL, CLIPTextEncoder, MultiViewUNet
from mvd_tpu_torch.pipeline import MVDPipeline

J_CFG, T_CFG = cut_config(J_TINY), cut_config(TINY_MODEL)
LAT = J_CFG.unet.sample_size
DEAD = "unet.base_unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.processor.ref_ln.weight"


def assert_trees_equal(got, want):
    got, want = flatten_dict(got), flatten_dict(want)
    assert set(got) == set(want), (set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def mvd_params():
    """Random JAX multi-view UNet params (numpy leaves, no jitted init)."""
    z = jnp.zeros((1, LAT, LAT, 4))
    cam = jnp.eye(4)[None]
    return random_params(
        JMVD(J_CFG).init, z, jnp.zeros((), jnp.int32), jnp.zeros((1, 77, J_CFG.unet.cross_attention_dim)),
        source_camera=cam, target_camera=cam, source_image_latents=z, seed=11,
    )["params"]


@pytest.fixture(scope="module")
def ckpt(mvd_params, tmp_path_factory):
    """A Lightning checkpoint of ``mvd_params``: the UNet under the names
    of the JAX package's export, the camera encoder under the reference's
    (held to the JAX converter below), and one dead reference param."""
    sd = {f"unet.base_unet.{k}": v for k, v in jconv.export_unet_state_dict(mvd_params["unet"]).items()}
    sd.update({k: v for k, v in export_lightning_state_dict(mvd_params).items()
               if k.startswith("unet.camera_encoder.")})
    sd[DEAD] = np.zeros((J_CFG.unet.block_out_channels[0],), np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "last.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "epoch": 3}, path)
    return str(path)


def test_lightning_checkpoint_converts_as_the_jax_package_does(ckpt, mvd_params):
    want, want_skipped = jconv.convert_lightning_checkpoint(ckpt)
    got, skipped = convert_lightning_checkpoint(ckpt)
    assert_trees_equal(got, want)
    assert skipped == want_skipped and [k for k, _ in skipped] == [DEAD[len("unet.base_unet."):]]
    # the synthetic checkpoint holds mvd_params under the reference's names
    expected = {k: v for k, v in mvd_params.items()}
    expected["camera_encoder"] = {k: v for k, v in mvd_params["camera_encoder"].items()
                                  if k != "translation_projection"}
    assert_trees_equal(want["params"], expected)


def test_loader_gives_the_jax_converters_parameters(ckpt):
    """JAX converter + ``load_jax_params`` (the translation projection
    copied across by hand, as the reference stores none) against the port's
    ``load_checkpoint``: bitwise equal, and the loader names the leaf it
    kept from init."""
    want_tree, _ = jconv.convert_lightning_checkpoint(ckpt)
    pipe = MVDPipeline.create(T_CFG, seed=3, device="cpu")
    init_projection = pipe.model["mvd"].camera_encoder.translation_projection.detach().clone()
    tree = dict(want_tree["params"])
    tree["camera_encoder"] = {**tree["camera_encoder"], "translation_projection": init_projection.numpy()}
    want = MultiViewUNet(T_CFG)
    load_jax_params(want, tree)

    kept, skipped = load_checkpoint(pipe, ckpt)
    assert kept == ["mvd.camera_encoder.translation_projection"] and len(skipped) == 1
    got = dict(pipe.model["mvd"].named_parameters())
    for name, p in want.named_parameters():
        assert torch.equal(got[name], p), name


def test_loader_rejects_what_it_cannot_place(ckpt, tmp_path):
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    pipe = MVDPipeline.create(T_CFG, seed=0, device="cpu")
    extra = dict(sd)
    extra["unet.base_unet.down_blocks.0.resnets.0.bogus.weight"] = torch.zeros(3)
    torch.save({"state_dict": extra}, tmp_path / "extra.ckpt")
    with pytest.raises(KeyError, match="bogus"):
        load_checkpoint(pipe, str(tmp_path / "extra.ckpt"))
    wrong = dict(sd)
    key = "unet.base_unet.conv_in.weight"
    wrong[key] = torch.zeros(wrong[key].shape[:1] + (5,) + wrong[key].shape[2:])
    torch.save({"state_dict": wrong}, tmp_path / "wrong.ckpt")
    with pytest.raises(ValueError, match="conv_in"):
        load_checkpoint(pipe, str(tmp_path / "wrong.ckpt"))
    with pytest.raises(ValueError, match="save_params"):  # a directory without params.pt
        load_checkpoint(pipe, str(tmp_path))


def test_ray_loader_zero_pads_conv_in(ckpt):
    """Under ray conditioning the loader pads a 4-channel conv_in with zero
    rows for the 6 ray channels, as ``zero_pad_conv_in`` does in JAX."""
    import dataclasses

    pipe = MVDPipeline.create(dataclasses.replace(T_CFG, use_ray_conditioning=True), seed=0, device="cpu")
    load_checkpoint(pipe, ckpt)
    tree, _ = jconv.convert_lightning_checkpoint(ckpt)
    want = jconv.zero_pad_conv_in(tree["params"]["unet"])["conv_in"]["kernel"]
    got = pipe.model["mvd"].unet.conv_in.weight.detach().numpy().transpose(2, 3, 1, 0)
    assert got.shape[2] == 10 and np.array_equal(got, want)


def test_unet_export_and_zero_pad_match_the_jax_package(mvd_params):
    unet = mvd_params["unet"]
    want, got = jconv.export_unet_state_dict(unet), export_unet_state_dict(unet)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    back, skipped = convert_unet_state_dict(got)
    assert_trees_equal(back, unet)
    assert skipped == []
    assert_trees_equal(zero_pad_conv_in(unet), jconv.zero_pad_conv_in(unet))
    assert_trees_equal(zero_pad_conv_in(unet, 3), jconv.zero_pad_conv_in(unet, 3))


def test_split_matches_the_jax_package():
    sd = {"unet.base_unet.a.weight": 1, "unet.camera_encoder.b.bias": 2, "image_encoder.c.weight": 3,
          "unet.image_encoder.unet.d.weight": 4, "other.e": 5, "f": 6}
    assert split_lightning_state_dict(sd) == jconv.split_lightning_state_dict(sd)


def test_export_jax_params_is_the_inverse_of_convert_jax_params():
    model = MVDPipeline.create(T_CFG, seed=1, device="cpu").model
    state = dict(model.named_parameters())
    back = convert_jax_params(export_jax_params(model))
    assert set(back) == set(state)
    assert all(np.array_equal(back[k], p.detach().numpy()) for k, p in state.items())


_VAE_NAMES = [
    (r"^(encoder)\.down_(\d+)_resnet_(\d+)\.", r"\1.down_blocks.\2.resnets.\3."),
    (r"^(encoder)\.down_(\d+)_downsample\.conv\.", r"\1.down_blocks.\2.downsamplers.0.conv."),
    (r"^(decoder)\.up_(\d+)_resnet_(\d+)\.", r"\1.up_blocks.\2.resnets.\3."),
    (r"^(decoder)\.up_(\d+)_upsample\.conv\.", r"\1.up_blocks.\2.upsamplers.0.conv."),
    (r"^(encoder|decoder)\.mid_resnet_(\d+)\.", r"\1.mid_block.resnets.\2."),
    (r"^(encoder|decoder)\.mid_attn\.", r"\1.mid_block.attentions.0."),
    (r"\.to_out\.", r".to_out.0."),
]


def _diffusers_state_dict(module, rules, rng):
    """Random tensors under the diffusers names of ``module``'s params."""
    sd = {}
    for name, p in module.named_parameters():
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        sd[name] = rng.normal(size=tuple(p.shape)).astype(np.float32)
    return sd


def test_vae_converter_matches_the_jax_package():
    vae = AutoencoderKL(T_CFG.vae)
    sd = _diffusers_state_dict(vae, _VAE_NAMES, np.random.default_rng(4))
    # an older checkpoint's mid attention q/k/v/out as 1x1 convs
    for key in [k for k in sd if re.search(r"mid_block\.attentions\.0\.to_[qkv]\.weight$", k)]:
        sd[key] = sd[key][:, :, None, None]
    want, got = jconv.convert_vae_state_dict(sd), convert_vae_state_dict(sd)
    assert_trees_equal(got, want)
    load_jax_params(vae, got)  # 1:1 with the port's VAE


def test_clip_converter_matches_the_jax_package():
    clip = CLIPTextEncoder(T_CFG.text_encoder)
    rules = [(r"^token_embedding\.", "embeddings.token_embedding."),
             (r"^position_embedding$", "embeddings.position_embedding.weight"),
             (r"^layers_(\d+)\.(fc\d)\.", r"encoder.layers.\1.mlp.\2."),
             (r"^layers_(\d+)\.", r"encoder.layers.\1."),
             (r"^", "text_model.")]
    sd = _diffusers_state_dict(clip, rules, np.random.default_rng(5))
    sd["text_model.embeddings.position_ids"] = np.arange(77)[None]
    want, got = jconv.convert_clip_text_state_dict(sd), convert_clip_text_state_dict(sd)
    assert_trees_equal(got, want)
    load_jax_params(clip, got)  # 1:1 with the port's CLIP
