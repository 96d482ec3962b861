"""Multi-device execution over torch.distributed (K10): read-shard data
parallelism, merged pileup counts, the index sharded over ranks
(`mesh.py`), and the PE insert-size exchange across ranks (`exchange.py`).
"""
