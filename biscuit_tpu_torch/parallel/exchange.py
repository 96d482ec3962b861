"""Allgather of PE insert sizes across ranks.

Port of biscuit_tpu/parallel/exchange.py. `FileAllgather` is the source's
file barrier for ranks that share a directory (each writes its payload to
<dir>/<name>.<batch>.<rank>.npy, waits for all n and returns the
rank-ordered concatenation), copied as is; `TorchProcessAllgather` takes the
place of `JaxProcessAllgather` over a torch.distributed process group.

Used for PE insert-size statistics: the reference computes pes over the
whole in-memory chunk (bwamem.c:464-467), so shards must pool their
candidate isizes to produce byte-identical pairing decisions regardless of
how the reads were partitioned (see align/pair.ISIZE_EXCHANGE).
"""
import os
import time

import numpy as np
import torch


class FileAllgather:
    """allgather(list[int]) -> list[int] across n ranks via a shared dir."""

    def __init__(self, directory: str, rank: int, n: int, name: str = "isize",
                 timeout: float = 600.0):
        self.dir = directory
        self.rank = rank
        self.n = n
        self.name = name
        self.timeout = timeout
        self.batch = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, batch: int, rank: int) -> str:
        return os.path.join(self.dir, f"{self.name}.{batch}.{rank}.npy")

    def __call__(self, values):
        b = self.batch
        self.batch += 1
        tmp = self._path(b, self.rank) + ".tmp"
        with open(tmp, "wb") as f:  # explicit handle: np.save must not
            np.save(f, np.asarray(list(values), dtype=np.int64))  # mangle it
        os.replace(tmp, self._path(b, self.rank))  # atomic publish
        merged = []
        deadline = time.time() + self.timeout
        for r in range(self.n):
            p = self._path(b, r)
            while not os.path.exists(p):
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {self.rank}: no {p} after {self.timeout}s")
                time.sleep(0.005)
            # NFS-style visibility: the np.load below can still race a
            # partially visible file only if os.replace were non-atomic on
            # the filesystem; retry reads defensively
            for _ in range(3):
                try:
                    merged.extend(np.load(p).tolist())
                    break
                except (ValueError, EOFError):
                    time.sleep(0.01)
            else:
                merged.extend(np.load(p).tolist())
        return merged


class TorchProcessAllgather:
    """allgather(list[int]) across the ranks of the torch.distributed
    process group, the source's JaxProcessAllgather contract: the counts
    are gathered, the values padded to the largest count, gathered and
    trimmed (parallel/mesh.all_gather); the result is in rank order, so
    pairing decisions do not depend on how the reads were partitioned."""

    def __init__(self):
        from .mesh import make_mesh
        self.mesh = make_mesh()

    def __call__(self, values):
        from .mesh import all_gather
        vals = torch.as_tensor(np.asarray(list(values), dtype=np.int64))
        return all_gather(vals, self.mesh).tolist()


def from_env(env: str = "BISCUIT_TPU_TORCH_PES_EXCHANGE"):
    """Parse 'dir:rank:n' (file barrier) or 'torch' (the process group of
    torch.distributed that the caller has joined, else this process alone)
    from the environment; None when unset."""
    spec = os.environ.get(env)
    if not spec:
        return None
    if spec == "torch":
        return TorchProcessAllgather()
    d, rank, n = spec.rsplit(":", 2)
    return FileAllgather(d, int(rank), int(n))
