"""The recipe drivers: `fastsvc1` (FastSVC, stages 0-5) and `baseline02`
(B02, stages 0-5 and 7), each run as `python -m
svcc23_fastsvc_tpu_torch.recipes.<name>`."""
