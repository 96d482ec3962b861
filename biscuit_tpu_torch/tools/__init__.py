"""Drivers over the port, run from the repository's root as
`python -m biscuit_tpu_torch.tools.<name>`: shard_align and shard_pileup
(copies of the repository's tools/ drivers, whose workers run the port's
CLI) and dist_run (multi-process execution over torch.distributed, with
its parity hashes and scaling).
"""
