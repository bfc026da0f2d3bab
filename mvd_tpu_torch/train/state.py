"""Train state: the freeze policy, AdamW over the trainable partition with a
global-norm clip, and the warmup-cosine learning rate.

Counterpart of ``mvd_tpu/train/state.py``. The JAX package partitions the
param tree by ``trainable_mask`` and gives the frozen leaves
``optax.set_to_zero``; here the frozen parameters get
``requires_grad=False``, so autograd computes no weight gradient for them,
and only the trainable ones enter the optimizer. The optimizer equals
optax's ``chain(clip_by_global_norm(max_norm), adamw(lr_schedule, b1, b2,
eps=1e-8, weight_decay))``:

* the clip scales every gradient by ``max_norm / ||g||`` when
  ``||g|| >= max_norm`` (no ``1e-6`` in the denominator, unlike
  ``torch.nn.utils.clip_grad_norm_``);
* ``torch.optim.AdamW``'s decoupled decay ``p *= 1 - lr * wd`` followed by
  ``p -= lr * m_hat / (sqrt(v_hat) + eps)`` is optax's
  ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; the decay covers
  every trainable parameter;
* optax reads the schedule at the count before the step, so step 1 runs at
  ``lr_schedule(0)``, which is 0 after warmup from 0: the first step moves
  nothing.

With ``grad_accum_steps`` k > 1 the optimizer is optax's
``MultiSteps(chain(clip, adamw), every_k_schedule=k)`` inside the trainable
branch: every call folds its gradients into a running mean
(``acc += (g - acc) / (n + 1)``), and every k-th call clips that mean by its
own global norm and takes one AdamW step on it, at
``lr_schedule(updates)``, the count of real updates; ``step`` counts calls.

The state updates the model and the optimizer in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.nn as nn

from ..config import OptimizerConfig, TrainConfig
from ..nn.layers import set_compute_dtype
from ..tensor_parallel import is_sharded

TRAINABLE_MARKERS = ("adapter_self", "adapter_cross", "camera_encoder")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def trainable_mask(module: nn.Module, train_denoising_unet: bool = False) -> Dict[str, bool]:
    """Parameter name -> trainable, for the multi-view UNet's parameters:
    the adapters and the camera encoder with its FiLM modulators, plus the
    whole UNet when ``train_denoising_unet``."""
    out = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")
        out[name] = any(m in parts for m in TRAINABLE_MARKERS) or (
            train_denoising_unet and "image_encoder_unet" not in parts
        )
    return out


def count_params(module: nn.Module, mask: Optional[Dict[str, bool]] = None, trainable: bool = True) -> int:
    """Parameter count, of all parameters or of one side of ``mask``."""
    return sum(
        p.numel() for name, p in module.named_parameters()
        if mask is None or mask[name] == trainable
    )


def make_lr_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule`` (0 -> peak over the warmup,
    cosine to 0 at ``total_steps``) or linear warmup then constant."""
    peak = cfg.learning_rate
    warmup = max(1, int(cfg.warmup_fraction * total_steps))
    decay = max(total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        if cfg.schedule == "constant":
            return peak
        frac = min(count - warmup, decay) / decay
        return peak * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def make_adamw(params: Iterable[nn.Parameter], betas=(0.9, 0.999), weight_decay: float = 0.0) -> torch.optim.AdamW:
    """optax's ``adamw(lr, b1, b2, eps=1e-8, weight_decay)`` over ``params``;
    the caller sets each group's ``lr`` before a step."""
    return torch.optim.AdamW(list(params), lr=0.0, betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], grad_norm: torch.Tensor, max_norm: float) -> None:
    """optax's ``clip_by_global_norm(max_norm)`` in place: every gradient
    scaled by ``max_norm / grad_norm`` where ``grad_norm >= max_norm``
    (``grad_norm`` is their global norm, a 0-d tensor on their device)."""
    coef = torch.where(grad_norm < max_norm, torch.ones_like(grad_norm), max_norm / grad_norm)
    torch._foreach_mul_(list(grads), coef)


@dataclasses.dataclass
class TrainState:
    """The networks ({"mvd", "vae", "text_encoder"}), the optimizer over the
    trainable parameters, and the count of steps taken."""

    model: nn.ModuleDict
    trainable: Dict[str, nn.Parameter]  # name under model["mvd"] -> f32 master
    optimizer: torch.optim.AdamW
    lr_schedule: Callable[[int], float]
    max_grad_norm: float
    grad_accum_steps: int = 1
    step: int = 0  # calls of apply_gradients
    updates: int = 0  # optimizer steps taken (step // grad_accum_steps)
    mini_step: int = 0  # calls folded into ``acc`` since the last update
    acc: Optional[Dict[str, torch.Tensor]] = None  # running mean of the gradients (k > 1)

    @classmethod
    def create(cls, model: nn.ModuleDict, cfg: TrainConfig, total_steps: int) -> "TrainState":
        """Freeze, cast and wrap ``model`` in place. Trainable parameters stay
        f32 masters; the frozen ones (outside norms) are cast to the compute
        dtype once, 4-D weights go to channels_last, and every Linear/Conv2d
        computes in the compute dtype. A model-sharded ``model`` raises:
        the model axis in training is not ported (ROADMAP item 17)."""
        if is_sharded(model):
            raise NotImplementedError("a model-sharded network does not train: the model axis in "
                                      "training (ROADMAP item 17) is not ported")
        dtype = DTYPES[cfg.model.dtype]
        mask = trainable_mask(model["mvd"], cfg.train_denoising_unet)
        trainable = {}
        for net, module in model.items():
            for name, p in module.named_parameters():
                train = net == "mvd" and mask[name]
                p.requires_grad_(train)
                data = p.data
                if not train and "norm" not in name.lower():
                    data = data.to(dtype)
                if data.dim() == 4:
                    data = data.contiguous(memory_format=torch.channels_last)
                p.data = data
                if train:
                    trainable[name] = p
        set_compute_dtype(model, None if dtype == torch.float32 else dtype)
        o = cfg.optimizer
        optimizer = make_adamw(trainable.values(), o.betas, o.weight_decay)
        return cls(model, trainable, optimizer, make_lr_schedule(o, total_steps), o.max_grad_norm,
                   cfg.grad_accum_steps)

    def zero_grad(self) -> None:
        for p in self.trainable.values():
            p.grad = None

    def grads(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters' gradients by name; a parameter that got
        none gets zeros (it still decays, as in optax)."""
        for p in self.trainable.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return {name: p.grad for name, p in self.trainable.items()}

    def _update(self, grad_norm: torch.Tensor) -> None:
        """Clip the gradients by their global norm ``grad_norm`` and take
        one AdamW step at ``lr_schedule(updates)``."""
        clip_by_global_norm_(self.grads().values(), grad_norm, self.max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(self.updates)
        self.optimizer.step()
        self.updates += 1

    def apply_gradients(self, grad_norm: torch.Tensor) -> None:
        """One call: with k = 1 clip by ``grad_norm`` (the global norm of
        the gradients) and step; with k > 1 fold the gradients into the
        running mean and, on every k-th call, clip the mean by its own norm
        and step on it."""
        k = self.grad_accum_steps
        if k == 1:
            self._update(grad_norm)
        else:
            grads = self.grads()
            if self.acc is None:
                self.acc = {n: torch.zeros_like(g) for n, g in grads.items()}
            n = self.mini_step
            for name, g in grads.items():
                self.acc[name] += (g - self.acc[name]) / (n + 1)
            self.mini_step = (n + 1) % k
            if self.mini_step == 0:
                for name, p in self.trainable.items():
                    p.grad = self.acc[name].clone()
                norm = torch.sqrt(sum(a.float().square().sum() for a in self.acc.values()))
                self._update(norm)
                for a in self.acc.values():
                    a.zero_()
        self.step += 1
