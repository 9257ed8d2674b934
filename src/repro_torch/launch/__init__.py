"""Process-group meshes of the port (:mod:`repro_torch.launch.mesh`)."""
