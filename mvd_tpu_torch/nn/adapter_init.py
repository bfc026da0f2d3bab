"""Initialize the cross-view adapters from the frozen base attention.

Counterpart of ``mvd_tpu/nn/adapter_init.py``, on torch weights (Linear
``(out, in)``). Wherever a module holds both ``attn1``/``attn2`` and its
adapter ``adapter_self``/``adapter_cross``, the adapter's q/out projections
become copies of the attention's and its k/v projections are adapted:

* equal shapes (every self adapter) -> copy;
* adapter input wider than the attention's (cross adapters in 1280-wide
  blocks, text width 1024) -> copy into the leading input columns, zero the
  rest;
* adapter input narrower (cross adapters in 320/640-wide blocks) -> the
  truncated weight *transposed* (the reference computes
  ``F.linear(eye(C), W[:, :C])``); defined only for a square result.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _adapt_kv_weight(base: torch.Tensor, out_f: int, in_f: int) -> torch.Tensor:
    """Map a frozen to_k/to_v weight (o_out, o_in) onto (out_f, in_f)."""
    o_out, o_in = base.shape
    if (out_f, in_f) == (o_out, o_in):
        return base.clone()
    m = min(out_f, o_out)
    if in_f >= o_in:
        w = torch.zeros((out_f, in_f), dtype=base.dtype, device=base.device)
        w[:m, :o_in] = base[:m]
        return w
    if m != in_f or in_f != out_f:
        raise ValueError(
            f"non-square K/V truncation ({out_f},{in_f}) from ({o_out},{o_in}) "
            "is undefined in the reference semantics"
        )
    # flax kernel K = W^T; the JAX rule K[:in, :m].T maps to W[:m, :in].T
    return base[:m, :in_f].t().clone()


@torch.no_grad()
def init_adapters_from_frozen(module: nn.Module) -> nn.Module:
    """Re-initialize every adapter under ``module`` from its attention, in
    place; returns ``module``."""
    for parent in module.modules():
        for attn_name, ad_name in (("attn1", "adapter_self"), ("attn2", "adapter_cross")):
            attn = getattr(parent, attn_name, None)
            ad = getattr(parent, ad_name, None)
            if attn is None or ad is None:
                continue
            ad.to_q_ref.weight.copy_(attn.to_q.weight)
            ad.to_out_ref.weight.copy_(attn.to_out.weight)
            ad.to_out_ref.bias.copy_(attn.to_out.bias)
            for src, dst in ((attn.to_k, ad.to_k_ref), (attn.to_v, ad.to_v_ref)):
                dst.weight.copy_(_adapt_kv_weight(src.weight, *dst.weight.shape))
    return module
