"""Launchers: the LM serving driver
(``python -m repro_torch.launch.serve``)."""
