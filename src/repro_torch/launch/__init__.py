"""Entry points: :mod:`repro_torch.launch.serve` (the LM decode loop),
:mod:`repro_torch.launch.analytics_serve` (the multi-session analytics
demo) and :mod:`repro_torch.launch.calibrate` (the measured cost
calibration harness)."""
