"""biscuit_tpu_torch — the PyTorch + CUDA port of biscuit_tpu.

The JAX package `biscuit_tpu` stays the reference. This package runs
`align` for single-end reads (FASTQ to SAM) through a torch port of the
JAX device engine, with its device kernels written by hand in CUDA for
Hopper (sm_90a) under `kernels/`, each beside a plain torch version that
the CPU runs. It imports torch and never jax: host modules that do not
reach jax are imported from `biscuit_tpu`, and the ones that do are copied
here with only their imports changed.
"""
