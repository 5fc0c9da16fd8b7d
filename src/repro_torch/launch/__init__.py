"""Entry points of the port: the serving launcher (:mod:`repro_torch.launch.serve`)."""
