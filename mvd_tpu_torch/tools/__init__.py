"""Offline tools of the port: the procedural corpus generator and VAE
pretraining (``python -m mvd_tpu_torch.tools.procedural``,
``python -m mvd_tpu_torch.tools.pretrain_vae``)."""
