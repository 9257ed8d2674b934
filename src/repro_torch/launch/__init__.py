"""Launchers of the port: process-group meshes
(:mod:`repro_torch.launch.mesh`) and the query-serving loop
(:mod:`repro_torch.launch.serve`)."""
