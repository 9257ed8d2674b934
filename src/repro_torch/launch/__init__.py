"""Launchers of the port: process-group meshes
(:mod:`repro_torch.launch.mesh`), the serving loops
(:mod:`repro_torch.launch.serve`: language-model ``generate`` and the
query service) and the training loop (:mod:`repro_torch.launch.train`)."""
