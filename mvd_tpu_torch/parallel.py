"""Config helpers of multi-device runs.

A copy of what the port needs of ``mvd_tpu/parallel.py``. Joint multi-view
attention runs on one device; a view axis sharded over several devices
(ring attention, K4) is ROADMAP item 16.
"""

from __future__ import annotations

import dataclasses


def for_view_sharding(model_cfg, num_views: int, view_devices: int):
    """Return a ModelConfig whose UNet runs joint attention over
    ``num_views`` with the view axis sharded over ``view_devices`` devices.
    Only ``view_devices == 1`` runs: more raise."""
    if view_devices > 1:
        raise NotImplementedError(
            f"views sharded over {view_devices} devices is ring attention across GPUs, "
            "ROADMAP item 16: not ported yet")
    unet = dataclasses.replace(model_cfg.unet, num_views=num_views, view_axis=None)
    return dataclasses.replace(model_cfg, unet=unet)
