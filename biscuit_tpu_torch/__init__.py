"""biscuit_tpu_torch — the PyTorch + CUDA port of biscuit_tpu.

The JAX package `biscuit_tpu` stays the reference. This package runs
`index`, `align` (FASTQ to SAM, single-end and paired-end, through a torch
port of the JAX device engine), `sort`, `bamindex`, `pileup` (sorted BAM
to VCF) and the subcommands downstream of it (`vcf2bed`, `mergecg`,
`epiread`, `rectangle`, `asm`), with its device kernels written by hand in
CUDA for Hopper (sm_90a) under `kernels/`, each beside a plain torch
version that the CPU runs. It imports torch, never jax, and nothing of `biscuit_tpu`: every host
module it needs is a copy of its own, held to its source by
tests/test_torch_engine.py.
"""

__version__ = "0.1.0"
# Version of the reference toolchain whose behaviour the package reproduces
REFERENCE_VERSION = "1.6.1-dev"
