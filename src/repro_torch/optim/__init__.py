from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["AdamWConfig", "adamw_init"]
