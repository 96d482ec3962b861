"""The companion scripts on the port's modules, each a copy of its namesake
in the repository's scripts/: `python -m biscuit_tpu_torch.scripts.QC`,
`.flip_pbat_strands` and `.pybiscuit`."""
