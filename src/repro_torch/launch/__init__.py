"""Entry points: :mod:`repro_torch.launch.serve` (the LM decode loop),
:mod:`repro_torch.launch.train` (the LM trainer),
:mod:`repro_torch.launch.analytics_serve` (the multi-session analytics
demo), :mod:`repro_torch.launch.calibrate` (the measured cost
calibration harness) and :mod:`repro_torch.launch.dryrun` (the dry run on
meta tensors, with :mod:`~repro_torch.launch.op_analysis` and
:mod:`~repro_torch.launch.scan_registry`)."""
