"""Read preprocessing: adaptor identification and clipping
(lib/aln/bwamem.c:238-303).

Copy of biscuit_tpu/align/io_helpers.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from typing import Optional

import numpy as np

from ..config import MemOpt
from ..io.fastq import BSeq


def identify_adaptor(seq: BSeq, adaptor: Optional[np.ndarray]) -> None:
    """read_identify_adaptor (bwamem.c:258-274): full memmem match anywhere,
    else longest adaptor prefix matching the read suffix."""
    if adaptor is None:
        seq.l_adaptor = 0
        return
    hay = seq.seq.tobytes()
    needle = np.asarray(adaptor, dtype=np.uint8).tobytes()
    pos = hay.find(needle)
    if pos >= 0:
        seq.l_adaptor = seq.l_seq - pos
        return
    for i in range(len(needle) - 1, 0, -1):
        if hay[seq.l_seq - i:] == needle[:i]:
            break
    else:
        i = 0
    seq.l_adaptor = i


def clip_by_quality(seq: BSeq, min_base_qual: int) -> None:
    """clip_read_by_quality (bwamem.c:276-284)."""
    if seq.qual is None:
        return
    while seq.clip5 < seq.l_seq - seq.clip3:
        if ord(seq.qual[seq.clip5]) >= min_base_qual + 33:
            break
        seq.clip5 += 1
    while seq.l_seq - seq.clip3 >= seq.clip5:
        if ord(seq.qual[seq.l_seq - seq.clip3 - 1]) >= min_base_qual + 33:
            break
        seq.clip3 += 1


def read_clipping(seq: BSeq, adaptor: Optional[np.ndarray], opt: MemOpt) -> None:
    """read_clipping (bwamem.c:286-303)."""
    identify_adaptor(seq, adaptor)
    seq.clip5 = opt.clip5
    seq.clip3 = opt.clip3 + seq.l_adaptor
    clip_by_quality(seq, opt.min_base_qual)
    seq.seq0 = seq.seq
    seq.l_seq0 = seq.l_seq
    seq.seq = seq.seq[seq.clip5:seq.l_seq - seq.clip3] if seq.l_seq - seq.clip3 - seq.clip5 > 0 \
        else seq.seq[seq.clip5:seq.clip5]
    seq.l_seq = max(seq.l_seq - seq.clip3 - seq.clip5, 0)