"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: random flax params from a numpy seed (no jitted init), the
signal-to-noise ratio the parity bars are stated in, the depth cut of
TINY_MODEL that keeps the JAX compiles short, and random metric-tower
weight files in their public layouts."""

import dataclasses
import math
import os

import jax
import numpy as np
import torch


def cut_config(cfg):
    """TINY_MODEL cut to two UNet levels of one resnet each and one VAE
    resnet per level (widths and the VAE's 8x scale kept): still a
    cross-attention level with adapters, the mid block, FiLM at every block
    boundary and the feature pass, at a fraction of the JAX compile. Works
    on the JAX package's config and on the port's alike."""
    unet = dataclasses.replace(
        cfg.unet, block_out_channels=(32, 64), num_attention_heads=(2, 4),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
    )
    vae = dataclasses.replace(cfg.vae, layers_per_block=1)
    return dataclasses.replace(cfg, unet=unet, vae=vae)


def snr_db(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    err = np.mean((want - got) ** 2)
    if err == 0:
        return np.inf
    return float(10 * np.log10(np.mean(want**2) / err))


def random_params(init_fn, *args, seed=0, **kwargs):
    """A flax param tree of numpy leaves shaped as ``init_fn(key, *args)``
    would make it (traced with ``jax.eval_shape``, never compiled), filled
    from ``np.random.default_rng(seed)``: kernels N(0, 1/fan_in), norm scales
    near 1, biases and other leaves small and nonzero."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, fan_in**-0.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            return rng.normal(0.0, shape[-1] ** -0.5, shape).astype(np.float32)
        if name in ("translation_projection",):
            return rng.normal(0.0, shape[0] ** -0.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def joint_train_inputs(cfg, B=1, V=2, seed=0):
    """A (B, V) train batch at ``cfg``'s latent size, as the latent cache
    gives it (posterior moments, so no VAE encode is compiled): one source
    view per group, V targets on an orbit."""
    from mvd_tpu.camera import orbit_cameras

    lat = cfg.unet.sample_size
    rng = np.random.default_rng(seed)
    cams = orbit_cameras(V).astype(np.float32)

    def moments(n):  # mean, logvar
        m = rng.normal(size=(B, n, 1, lat, lat, 4)).astype(np.float32)
        return np.concatenate([m, -2.0 + 0.1 * m], axis=2)

    return {
        "source_moments": np.repeat(moments(1), V, axis=1),
        "target_moments": moments(V),
        "source_camera": np.tile(cams[:1], (B, V, 1, 1)),
        "target_camera": np.tile(cams[None], (B, 1, 1, 1)),
        "input_ids": rng.integers(0, cfg.text_encoder.vocab_size, (B, V, 77)).astype(np.int32),
    }


def jax_train_draws(key, schedule, n, lat):
    """The JAX train step's draws (mvd_tpu/train/step.py: r_noise, r_t,
    r_vs, r_vt) as numpy, for ``n`` flat rows of ``lat``² latents."""
    import jax.numpy as jnp

    shape = (n, lat, lat, 4)
    r_noise, r_t, r_vs, r_vt = jax.random.split(key, 4)
    return {
        "noise": np.array(jax.random.normal(r_noise, shape, jnp.float32)),
        "timesteps": np.array(jax.random.randint(r_t, (n,), 0, schedule.num_train_timesteps)),
        "source_vae_noise": np.array(jax.random.normal(r_vs, shape, jnp.float32)),
        "target_vae_noise": np.array(jax.random.normal(r_vt, shape, jnp.float32)),
    }


_JOINT_RUN = {}


def jax_joint_train_run():
    """The loss and gradient norms of one JAX train step on the depth-cut
    TINY_MODEL with joint attention over 2 views and remat on (its
    default), from random params: (params, batch, draws, metrics as numpy).
    The step's own loss function and gradient (``mvd_tpu/train/step.py``:
    ``make_loss_fn`` with the source rows deduplicated, ``value_and_grad``
    over the trainable split, ``grad_group_norms``) under one ``jax.jit``;
    the optimizer update, which the metrics do not read, is left out, as is
    the step's ahead-of-time compile with its layout search, which cost
    more than the rest. Computed once per process: the joint and the remat
    tests share it."""
    if _JOINT_RUN:
        return _JOINT_RUN
    import jax.numpy as jnp

    from mvd_tpu.config import TINY_MODEL, TrainConfig
    from mvd_tpu.nn import AutoencoderKL, CLIPTextEncoder, MultiViewUNet
    from mvd_tpu.parallel import for_view_sharding
    from mvd_tpu.pipeline import MVDPipeline
    from mvd_tpu.train import step as jstep
    from mvd_tpu.train import trainable_mask

    V = 2
    cfg = cut_config(TINY_MODEL)
    cfg = for_view_sharding(cfg, V, 1)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, remat=True))
    lat = cfg.unet.sample_size
    z = jnp.zeros((V, lat, lat, 4))
    cam = jnp.tile(jnp.eye(4)[None], (V, 1, 1))
    params = {
        "mvd": random_params(MultiViewUNet(cfg).init, z, jnp.zeros((), jnp.int32),
                             jnp.zeros((V, 77, cfg.unet.cross_attention_dim)),
                             source_camera=cam, target_camera=cam, source_image_latents=z, seed=21),
        "vae": random_params(AutoencoderKL(cfg.vae).init, jnp.zeros((1, 16, 16, 3)), seed=22),
        "text_encoder": random_params(CLIPTextEncoder(cfg.text_encoder).init,
                                      jnp.zeros((1, 77), jnp.int32), seed=23),
    }
    tcfg = TrainConfig(model=cfg, batch_size=1, image_size=lat * 8, num_views=V)
    pipe = MVDPipeline(cfg, jax.tree.map(jnp.asarray, params))
    loss_fn = jstep.make_loss_fn(pipe, pipe.schedule, tcfg,
                                 source_repeat=V if tcfg.unique_source_encode else 1)
    mvd = jax.tree.map(jnp.asarray, params["mvd"])
    t_params, f_params = jstep.split_params(mvd, trainable_mask(mvd, tcfg.train_denoising_unet))

    def metrics_of(t_params, frozen, batch, rng):
        def loss_t(tp):
            return loss_fn(jstep.merge_params(tp, f_params), frozen, batch, rng)

        (_, metrics), grads = jax.value_and_grad(loss_t, has_aux=True)(t_params)
        return {**metrics, **jstep.grad_group_norms(grads)}

    frozen = {"vae": pipe.params["vae"], "text_encoder": pipe.params["text_encoder"]}
    batch = joint_train_inputs(cfg, V=V)
    flat = {k: jstep._flat(jnp.asarray(v)) for k, v in batch.items()}
    key = jax.random.PRNGKey(31)
    m = jax.jit(metrics_of)(t_params, frozen, flat, key)
    _JOINT_RUN.update(params=params, batch=batch, metrics={k: np.asarray(v) for k, v in m.items()},
                      draws=jax_train_draws(key, pipe.schedule, V, lat))
    return _JOINT_RUN


# ---------------------------------------------------------------- tower files
# random weights of the metric towers in their public state-dict layouts
# (torchvision vgg16, an lpips file with its AlexNet trunk under net.,
# transformers CLIPVisionModelWithProjection, pytorch-fid InceptionV3),
# He-normal convolutions and running variance 1 so activations stay finite

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
ALEX = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
CLIP_ARCHS = {  # the two families at small widths, 2 layers, 224² input
    "l": dict(hidden=128, heads=2, inter=256, proj=96, patch=14, image=224),
    "h": dict(hidden=160, heads=2, inter=320, proj=128, patch=14, image=224),
}


def _he(gen, shape):
    fan_in = int(np.prod(shape[1:]))
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)


def _vgg_sd(seed=0):
    """torchvision vgg16 layout: features.N.{weight,bias} and a classifier
    key that both loaders ignore."""
    gen = torch.Generator().manual_seed(seed)
    sd, in_ch, tv = {}, 3, 0
    for c in VGG16_CFG:
        if c == "M":
            tv += 1
            continue
        sd[f"features.{tv}.weight"] = _he(gen, (c, in_ch, 3, 3))
        sd[f"features.{tv}.bias"] = 0.1 * torch.randn(c, generator=gen)
        in_ch, tv = c, tv + 2
    sd["classifier.6.bias"] = torch.zeros(1000)
    return sd


def _lins(gen, chans):
    return {f"lin{i}.model.1.weight": 0.1 * torch.rand((1, c, 1, 1), generator=gen)
            for i, c in enumerate(chans)}


def _lpips_alex_sd(seed=1):
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for idx, (ic, oc, k) in zip((0, 3, 6, 8, 10), ALEX):
        sd[f"net.features.{idx}.weight"] = _he(gen, (oc, ic, k, k))
        sd[f"net.features.{idx}.bias"] = 0.1 * torch.randn(oc, generator=gen)
    sd.update(_lins(gen, [c[1] for c in ALEX]))
    return sd


def _clip_sd(arch, layers=2, seed=2):
    """transformers CLIPVisionModelWithProjection key layout."""
    gen = torch.Generator().manual_seed(seed)
    D, inter, P = arch["hidden"], arch["inter"], arch["patch"]
    n_pos = 1 + (arch["image"] // P) ** 2
    rn = lambda *s, std: std * torch.randn(s, generator=gen)
    e = "vision_model.embeddings."
    sd = {e + "class_embedding": rn(D, std=1.0), e + "patch_embedding.weight": rn(D, 3, P, P, std=(3 * P * P) ** -0.5),
          e + "position_embedding.weight": rn(n_pos, D, std=0.1),
          "vision_model.pre_layrnorm.weight": 1 + rn(D, std=0.1), "vision_model.pre_layrnorm.bias": rn(D, std=0.1),
          "vision_model.post_layernorm.weight": 1 + rn(D, std=0.1), "vision_model.post_layernorm.bias": rn(D, std=0.1),
          "visual_projection.weight": rn(arch["proj"], D, std=D**-0.5)}
    for i in range(layers):
        pre = f"vision_model.encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[pre + f"self_attn.{n}.weight"] = rn(D, D, std=D**-0.5)
            sd[pre + f"self_attn.{n}.bias"] = rn(D, std=0.1)
        for n in ("layer_norm1", "layer_norm2"):
            sd[pre + f"{n}.weight"] = 1 + rn(D, std=0.1)
            sd[pre + f"{n}.bias"] = rn(D, std=0.1)
        sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"] = rn(inter, D, std=D**-0.5), rn(inter, std=0.1)
        sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"] = rn(D, inter, std=inter**-0.5), rn(D, std=0.1)
    return sd


def _inception_sd(seed=3):
    """pytorch-fid key layout (built from the port's module names, plus the
    ``fc.`` head and ``num_batches_tracked`` that the converters drop)."""
    from mvd_tpu_torch.metrics.inception import InceptionV3Features

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in InceptionV3Features().state_dict().items():
        if name.endswith("conv.weight"):
            sd[name] = _he(gen, t.shape)
        elif name.endswith("running_var"):
            sd[name] = torch.ones(t.shape)
            sd[name.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
        else:
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    return {"inception." + k: v for k, v in sd.items()}


def write_tower_files(directory) -> dict:
    """One random state dict per tower in its public layout, written to
    ``directory``; returns {name: path}."""
    out = {}
    for name, sd in [("vgg", _vgg_sd()), ("lpips_alex", _lpips_alex_sd()),
                     ("lpips_vgg", _lins(torch.Generator().manual_seed(4), [64, 128, 256, 512, 512])),
                     ("clip_l", _clip_sd(CLIP_ARCHS["l"])), ("clip_h", _clip_sd(CLIP_ARCHS["h"])),
                     ("inception", _inception_sd())]:
        out[name] = os.path.join(str(directory), f"{name}.pth")
        torch.save(sd, out[name])
    return out
