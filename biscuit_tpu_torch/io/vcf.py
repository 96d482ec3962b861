"""Minimal VCF reader — replaces the external wzvcf dependency
(src/vcf2bed.c uses wzvcf from huishenlab/utils).

Copy of biscuit_tpu/io/vcf.py with only this docstring
changed: its imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class VcfRecord:
    tid: int
    chrom: str
    pos: int          # 1-based
    id: str
    ref: str
    alt: str
    qual: str
    filter: str
    info: str
    fmt: str
    samples: List[str]

    def info_get(self, key: str) -> Optional[str]:
        for kv in self.info.split(";"):
            if kv.startswith(key + "="):
                return kv[len(key) + 1:]
            if kv == key:
                return ""
        return None

    def fmt_get(self, key: str, sample_idx: List[int]) -> Optional[List[str]]:
        keys = self.fmt.split(":")
        if key not in keys:
            return None
        ki = keys.index(key)
        out = []
        for si in sample_idx:
            parts = self.samples[si].split(":")
            out.append(parts[ki] if ki < len(parts) else ".")
        return out


class VcfFile:
    def __init__(self, path: str):
        self.path = path
        self.contigs: List[Tuple[str, int]] = []
        self._name2tid: Dict[str, int] = {}
        self.samples: List[str] = []
        self.target_idx: List[int] = []
        opener = gzip.open if path.endswith(".gz") else open
        self._f = opener(path, "rt")
        self._pending = None
        for line in self._f:
            if line.startswith("##"):
                if line.startswith("##contig=<"):
                    body = line.strip()[10:-1]
                    d = dict(kv.split("=", 1) for kv in body.split(","))
                    self._name2tid[d["ID"]] = len(self.contigs)
                    self.contigs.append((d["ID"], int(d.get("length", 0))))
            elif line.startswith("#CHROM"):
                self.samples = line.rstrip("\n").split("\t")[9:]
                break
        self.target_idx = list(range(len(self.samples)))

    def select_samples(self, spec: str) -> None:
        """wzvcf index_vcf_samples: FIRST | LAST | ALL | name,name..."""
        if spec == "ALL":
            self.target_idx = list(range(len(self.samples)))
        elif spec == "FIRST":
            self.target_idx = [0] if self.samples else []
        elif spec == "LAST":
            self.target_idx = [len(self.samples) - 1] if self.samples else []
        else:
            names = spec.split(",")
            self.target_idx = [self.samples.index(n) for n in names]

    def raw_body(self):
        """Raw body lines (post-header), for callers that pre-filter with a
        substring test before paying for the full parse."""
        for line in self._f:
            if not line.strip() or line.startswith("#"):
                continue
            yield line

    def parse_line(self, line: str):
        return self._parse(line)

    def __iter__(self):
        for line in self.raw_body():
            yield self._parse(line)

    def _parse(self, line):
            f = line.rstrip("\n").split("\t")
            chrom = f[0]
            tid = self._name2tid.get(chrom, -1)
            if tid < 0 and chrom not in self._name2tid:
                # contig not declared in header: register on the fly
                self._name2tid[chrom] = len(self.contigs)
                self.contigs.append((chrom, 0))
                tid = self._name2tid[chrom]
            return VcfRecord(tid=tid, chrom=chrom, pos=int(f[1]), id=f[2],
                            ref=f[3], alt=f[4], qual=f[5], filter=f[6],
                            info=f[7], fmt=f[8] if len(f) > 8 else "",
                            samples=f[9:])

    def close(self):
        self._f.close()
