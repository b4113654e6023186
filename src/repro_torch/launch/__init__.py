"""Launchers of the port (counterpart of ``repro/launch``): the training
CLI, ``python -m repro_torch.launch.train``."""
