"""The port's measurement probes: the hand-written kernels P1-P3
(probe_kernels.py) and the three entry points that time them, run as
`python -m sgdnet_tpu_torch.tools.<name>`."""
