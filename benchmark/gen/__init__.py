"""Generators of the benchmark's inputs: genome, sample, reads, BAM."""
