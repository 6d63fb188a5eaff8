"""Checkpoints of the port, the reference's ``checkpoint/ckpt.py``."""
from repro_torch.checkpoint.ckpt import latest_step, restore_arrays, restore_into, save_checkpoint

__all__ = ["latest_step", "restore_arrays", "restore_into", "save_checkpoint"]
