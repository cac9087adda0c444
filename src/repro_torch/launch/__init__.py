"""Entry points: :mod:`repro_torch.launch.serve`, the LM decode loop."""
