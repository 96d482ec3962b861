"""The port's hybrid engine (device seeds into the native C++ engine) against
the JAX package's hybrid and native engines and the port's own.

On the CPU the port's DeviceSeeder runs the plain versions of K3
(collect_intv_flat) and K4's interval entry (sa_batch_intervals); the C++
engine is the port's copy of align_host.cpp. On the same reads and one index
the port's `process_seqs_hybrid` must give the SAM of its native and host
engines and of the JAX package's `process_seqs_hybrid` and
`process_seqs_native`, byte for byte: SE, SE in pipelined sub-batches, PE
with -b 0 and -b 1, -e (which the JAX hybrid leaves to C++ and the port
injects), SA_CAP 0 and 64. The injection's arrays equal the JAX seeder's,
its offsets and total agree, and a read the seeder flags (a homopolymer over
S = 128 rows) seeds in C++. A chunk the C++ fused entries cannot take
(-V, a read at their length gate) runs on the device engine. Then the CLI's
engine switch. Models:
tests/test_hybrid_engine.py and tests/test_native_engine.py.

The JAX seeder compiles once for each shape of its input: every JAX hybrid
call here takes 128 lanes of at most 128 bases (SE: 64 reads, two strands
each; PE -b 0: 32 pairs; PE -b 1: 64 pairs, one strand a read).
"""
import threading

import numpy as np
import pytest
import torch

from biscuit_tpu.align import device_engine as jeng
from biscuit_tpu.align.native_engine import \
    process_seqs_native as jax_native
from biscuit_tpu.align.pipeline import AlignerState as JaxState
from biscuit_tpu.index.build import build_index as jax_build_index
from biscuit_tpu_torch import cli
from biscuit_tpu_torch.align import device_engine as eng
from biscuit_tpu_torch.align import native_engine as neng
from biscuit_tpu_torch.align.io_helpers import read_clipping
from biscuit_tpu_torch.align.native_engine import process_seqs_native
from biscuit_tpu_torch.align.pipeline import AlignerState, process_seqs
from biscuit_tpu_torch.config import (MEM_F_NO_MULTI, MEM_F_PE,
                                      MEM_F_REF_HDR, MEM_F_SELF_OVLP)

from torch_testdata import (jax_opt, load_pairs, load_reads, make_dataset,
                            port_index, port_opt, seed_edge_reads)

torch.set_num_threads(1)

N_SE, N_PAIRS = 64, 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 60 kbp genome with 64 SE reads of 100 bp (SNPs, an indel in two
    of every four) and 64 pairs of 100 bp on the same genome (the generator
    draws the genome first), one index for both packages, and one JAX
    seeder."""
    d = tmp_path_factory.mktemp("thyb")
    fa, fq, _ = make_dataset(d, genome_size=60000, n_reads=N_SE, seed=11,
                             snp_rate=0.01, indel_every=4, index=False)
    pfa, pfqs, _ = make_dataset(d / "pe", genome_size=60000, n_reads=N_PAIRS,
                                seed=11, snp_rate=0.01, pe=True, index=False)
    with open(fa) as f, open(pfa) as g:
        assert f.read() == g.read()
    jidx = jax_build_index(fa, prefix=fa)
    jst, tst = JaxState(jidx), AlignerState(port_index(jidx))
    return {"fa": fa, "se": fq, "pe": pfqs, "jst": jst, "tst": tst,
            "jseeder": jeng.DeviceSeeder(jst),
            "seeder": eng.DeviceSeeder(tst, "cpu"), "jax_sam": {}}


def _reads(data, layout, jax_pkg=False):
    if layout == "se":
        return load_reads(data["se"], N_SE, jax_pkg=jax_pkg)
    pairs = load_pairs(*data["pe"], jax_pkg=jax_pkg)
    return pairs[:N_PAIRS] if layout == "pe0" else pairs  # -b 0: 32 pairs


def _flags(layout, e):
    return (MEM_F_NO_MULTI | (0 if layout == "se" else MEM_F_PE)
            | (MEM_F_SELF_OVLP if e else 0))


def _jax(data, layout, e):
    """The JAX package's hybrid and native SAM of a layout (computed once)."""
    key = (layout, e)
    if key not in data["jax_sam"]:
        bmode = 1 if layout == "pe1" else 0
        out = []
        for run, kw in ((jeng.process_seqs_hybrid, {"seeder": data["jseeder"]}),
                        (jax_native, {})):
            seqs = _reads(data, layout, jax_pkg=True)
            run(jax_opt(_flags(layout, e), parent=bmode), data["jst"], seqs, 0,
                **kw)
            out.append([s.sam for s in seqs])
        data["jax_sam"][key] = out
    return data["jax_sam"][key]


def _port(data, run, layout, e, **kw):
    seqs = _reads(data, layout)
    bmode = 1 if layout == "pe1" else 0
    run(port_opt(_flags(layout, e), parent=bmode), data["tst"], seqs, 0, **kw)
    return [s.sam for s in seqs]


CASES = {  # id: (layout, -e, SA_CAP, DEVICE_BATCH)
    "se_cap0": ("se", False, 0, None),
    "se_cap64": ("se", False, 64, None),
    "se_pipelined": ("se", False, 8, 16),
    "se_e": ("se", True, 8, None),
    "pe_b0_cap0": ("pe0", False, 0, None),
    "pe_b0_cap64": ("pe0", False, 64, None),
    "pe_b1": ("pe1", False, 8, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_matches_every_engine(data, case, monkeypatch):
    """The port's hybrid SAM equals its native and host engines' and the
    JAX package's hybrid and native engines'. Pipelined: 64 reads in four
    sub-batches of 16, each injection built in the injector thread; the JAX
    hybrid's SAM of the same reads (serial: its XLA seeder keeps one shape)
    is the same by its own contract."""
    layout, e, cap, batch = CASES[case]
    monkeypatch.setattr(eng.DeviceSeeder, "SA_CAP", cap)
    seeder = data["seeder"]
    calls = []
    if batch:
        monkeypatch.setattr(eng, "DEVICE_BATCH", batch)
        real = seeder.build_injection
        monkeypatch.setattr(seeder, "build_injection", lambda *a: calls.append(
            threading.current_thread() is threading.main_thread()) or real(*a))
    eng.reset_stages()
    hybrid = _port(data, eng.process_seqs_hybrid, layout, e, seeder=seeder)
    rep = eng.stage_report()
    jhyb, jnat = _jax(data, layout, e)
    assert hybrid == _port(data, process_seqs_native, layout, e) == jnat == jhyb
    assert hybrid == _port(data, process_seqs, layout, e)
    assert rep["inject"] > 0 and rep["native"] > 0
    assert rep["sa_rows"] > 0 and (rep["sa_jobs"] > 0) == (cap > 0)
    assert rep["seed_overflow_lanes"] == 0
    if batch:
        assert calls == [False] * (N_SE // batch)


def test_serial_switch_gives_the_pipelined_sam(data, monkeypatch):
    monkeypatch.setattr(eng, "DEVICE_BATCH", 32)
    piped = _port(data, eng.process_seqs_hybrid, "se", False,
                  seeder=data["seeder"])
    monkeypatch.setenv("BISCUIT_TPU_HYBRID_PIPELINE", "0")
    assert _port(data, eng.process_seqs_hybrid, "se", False,
                 seeder=data["seeder"]) == piped


@pytest.mark.parametrize("e", [False, True])
def test_injection_covers_every_lane(data, e):
    """Every lane of a batch gets has = 1 and rows, under -e too (the JAX
    seeder returns no injection there and leaves the batch to C++)."""
    seqs = _reads(data, "se")
    opt = port_opt(_flags("se", e))
    for s in seqs:
        read_clipping(s, opt.adaptor1, opt)
    inj, keep = data["seeder"].build_injection(opt, seqs, False)
    has, lane_off = keep[0], keep[1]
    assert has.dtype == np.uint8 and has.sum() == 2 * N_SE
    assert (np.diff(lane_off) > 0).sum() > N_SE
    assert isinstance(inj, neng.SeedInjC)


def _injections(data, layout, cap, monkeypatch, sweep_bytes=None):
    """(the port's injection arrays, the JAX seeder's) for the same
    clipped reads at SA_CAP `cap`."""
    monkeypatch.setattr(eng.DeviceSeeder, "SA_CAP", cap)
    monkeypatch.setattr(jeng.DeviceSeeder, "SA_CAP", cap)
    if sweep_bytes:
        monkeypatch.setattr(eng.DeviceSeeder, "SWEEP_BYTES", sweep_bytes)
    pe = layout != "se"
    bmode = 1 if layout == "pe1" else 0
    out = []
    for jax_pkg, seeder in ((False, data["seeder"]), (True, data["jseeder"])):
        seqs = _reads(data, layout, jax_pkg)
        opt = (jax_opt if jax_pkg else port_opt)(_flags(layout, False),
                                                 parent=bmode)
        for s in seqs:
            (jeng.read_clipping if jax_pkg else read_clipping)(
                s, opt.adaptor1 if (not pe or s.id % 2 == 0) else opt.adaptor2,
                opt)
        out.append(seeder.build_injection(opt, seqs, pe)[1][:6])
    return out


@pytest.mark.parametrize("layout", ["se", "pe0", "pe1"])
def test_injection_arrays_equal_the_jax_seeders(data, layout, monkeypatch):
    """has, lane_off, rows_se, rows_xs, sa_off and sa_pos, at SA_CAP 64:
    the rows grouped by lane key with each lane's in the seeder's order (an
    even PE read seeds its parent strand first)."""
    port, theirs = _injections(data, layout, 64, monkeypatch)
    for name, a, b in zip(("has", "lane_off", "rows_se", "rows_xs", "sa_off",
                           "sa_pos"), port, theirs):
        assert a.dtype == b.dtype and a.flags.c_contiguous, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(port[5]) > 1


def test_offsets_and_total_agree_over_several_sweeps(data, monkeypatch):
    """With a sweep of 37 lanes (PE: a read's two lanes split between two
    calls of the seeder), the injection is the one-sweep injection; K4
    filled exactly sa_pos, whose length is sa_off's last entry, and each
    row asked for min(size, SA_CAP) occurrences."""
    one, _j = _injections(data, "pe0", 8, monkeypatch)
    calls = []
    real = eng.collect_intv_flat
    monkeypatch.setattr(eng, "collect_intv_flat",
                        lambda *a: calls.append(a[1].shape[0]) or real(*a))
    few, _j = _injections(data, "pe0", 8, monkeypatch, sweep_bytes=37 *
                          eng.seed_lane_bytes(100, False, "cpu"))
    assert calls == [37, 37, 37, 17]
    for a, b in zip(one, few):
        np.testing.assert_array_equal(a, b)
    has, lane_off, rows_se, rows_xs, sa_off, sa_pos = few
    assert sa_off[0] == 0 and sa_off[-1] == len(sa_pos)
    np.testing.assert_array_equal(np.diff(sa_off),
                                  np.minimum(rows_xs[:, 2], 8))
    assert lane_off[-1] == len(rows_se) == len(rows_xs) == len(sa_off) - 1
    assert ((np.diff(lane_off) > 0) <= (has == 1)).all()


def test_a_read_over_the_seeders_rows_seeds_in_cpp(tmp_path):
    """A homopolymer of 150 bases on a 1 Mbp genome gives one lane more
    than S = 128 rows: K3 flags it, it keeps has = 0 and the C++ engine
    seeds it. The hybrid's and the device engine's SAM (the device engine
    hands that lane's host rows to K4's interval entry after the
    seeder's) equal the host engine's."""
    from biscuit_tpu_torch.io.fastq import make_bseq
    fa, fq, idx = make_dataset(tmp_path, genome_size=1_000_000, n_reads=8,
                               seed=7, read_len=150)
    st = AlignerState(idx)
    genuine = [s.seq for s in load_reads(fq, 6)]
    extra = seed_edge_reads(genuine)[10:13]  # homopolymer, 2-mer, 7-mer repeats

    def reads():
        seqs = load_reads(fq, 8)
        for k, x in enumerate(extra):
            seqs.append(make_bseq(f"edge{k}", None, "".join(
                "ACGTN"[int(c)] for c in x), "I" * len(x)))
            seqs[-1].id = len(seqs) - 1
        return seqs

    def sam(run, **kw):
        seqs = reads()
        run(port_opt(MEM_F_NO_MULTI), st, seqs, 0, **kw)
        return [s.sam for s in seqs]
    want = sam(process_seqs)
    eng.reset_stages()
    assert sam(eng.process_seqs_hybrid, device="cpu") == want
    assert eng.stage_report()["seed_overflow_lanes"] == 1
    eng.reset_stages()
    assert sam(eng.process_seqs_device, device="cpu") == want
    rep = eng.stage_report()
    assert rep["seed_overflow_lanes"] == 1 and rep["sa_overflow_jobs"] > 0


def test_a_seeder_error_is_raised_not_answered_by_cpp(data, monkeypatch):
    """No path catches the device seeder's failure to run the native
    engine instead: serial and pipelined, the error reaches the caller."""
    def broken(*a, **k):
        raise RuntimeError("seeder failed")
    monkeypatch.setattr(eng, "collect_intv_flat", broken)
    with pytest.raises(RuntimeError, match="seeder failed"):
        _port(data, eng.process_seqs_hybrid, "pe0", False,
              seeder=data["seeder"])
    monkeypatch.setattr(eng, "DEVICE_BATCH", 16)
    with pytest.raises(RuntimeError, match="seeder failed"):
        _port(data, eng.process_seqs_hybrid, "se", False,
              seeder=data["seeder"])


UNFUSED = {  # id: (layout, flags, MemOpt fields)
    "V_se": ("se", MEM_F_REF_HDR, {}),
    "V_pe": ("pe0", MEM_F_REF_HDR, {}),
    # -W 4: 0.05 x 100 bases >= 1.1 x 4, the gate of align1_core
    "W_pe": ("pe0", 0, {"min_chain_weight": 4}),
}


@pytest.mark.parametrize("case", list(UNFUSED))
def test_chunks_the_fused_entries_cannot_take_run_on_the_device_engine(
        data, case, monkeypatch):
    """Under -V, or with a read at the C++ length gate, the native engine
    would seed the chunk again on the host and drop the card's rows. The
    hybrid hands such a chunk to the device engine on its seeder's tables:
    no injection is built, the device engine's stages run, and the SAM is
    the host engine's."""
    layout, flag, fields = UNFUSED[case]
    seeder = data["seeder"]

    def no_injection(*a):
        raise AssertionError("an injection was built")
    monkeypatch.setattr(seeder, "build_injection", no_injection)
    seqs = _reads(data, layout)[:32]
    opt = port_opt(_flags(layout, False) | flag, **fields)
    assert not eng.fused(opt, seqs)
    assert eng.fused(port_opt(_flags(layout, False)), seqs)
    eng.reset_stages()
    eng.process_seqs_hybrid(opt, data["tst"], seqs, 0, seeder=seeder)
    rep = eng.stage_report()
    assert "inject" not in rep and "native" not in rep and rep["seed"] > 0
    assert seeder.aligner().fmpair is seeder.fmpair
    want = _reads(data, layout)[:32]
    process_seqs(port_opt(_flags(layout, False) | flag, **fields),
                 data["tst"], want, 0)
    assert [s.sam for s in seqs] == [s.sam for s in want]


# ---------------------------------------------------------------------------
# the CLI's engine switch
# ---------------------------------------------------------------------------

@pytest.fixture()
def engines_called(monkeypatch):
    """The engines that ran, in order (each still runs)."""
    from biscuit_tpu_torch.align import pipeline
    called = []
    for mod, name in ((eng, "process_seqs_hybrid"), (eng, "process_seqs_device"),
                      (neng, "process_seqs_native"), (pipeline, "process_seqs")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            called.append(_n) or _r(*a, **k))
    return called


@pytest.mark.parametrize("engine, want", [
    (None, ["process_seqs_hybrid", "process_seqs_native"]),
    ("device", ["process_seqs_hybrid", "process_seqs_native"]),
    ("device-jax", ["process_seqs_device"]),
    ("native", ["process_seqs_native"]),
    ("host", ["process_seqs"]),
    # -V: the hybrid hands the chunk to the device engine
    ("device -V", ["process_seqs_hybrid", "process_seqs_device"])])
def test_cli_engine_switch(data, engine, want, engines_called, monkeypatch,
                           capsys):
    """The default engine is `device`, the hybrid; `native` and `host` run
    only when named, each alone; every engine prints the same SAM."""
    monkeypatch.setenv("BISCUIT_TPU_TORCH_DEVICE", "cpu")
    engine, *opts = (engine or "-").split()
    if engine == "-":
        monkeypatch.delenv("BISCUIT_TPU_TORCH_ENGINE", raising=False)
    else:
        monkeypatch.setenv("BISCUIT_TPU_TORCH_ENGINE", engine)
    path = data["se"] + ".16.fq"
    with open(data["se"]) as f, open(path, "w") as g:
        g.writelines(f.readlines()[:64])
    assert cli.main_align([*opts, data["fa"], path]) == 0
    assert engines_called == want
    body = [ln + "\n" for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("@")]
    seqs = load_reads(path, 16)
    process_seqs(port_opt(MEM_F_NO_MULTI | (MEM_F_REF_HDR if opts else 0)),
                 data["tst"], seqs, 0)
    assert body == [s.sam for s in seqs]


def test_cli_default_engine_needs_the_card_and_named_host_engines_do_not(
        data, monkeypatch, capsys):
    """With no device named and no card, the default engine raises (it
    runs on the card, and never falls back to the native engine), while
    `native` and `host` align; -v 4 takes the host engine; an unknown engine
    exits 1."""
    monkeypatch.delenv("BISCUIT_TPU_TORCH_DEVICE", raising=False)
    path = data["se"] + ".4.fq"
    with open(data["se"]) as f, open(path, "w") as g:
        g.writelines(f.readlines()[:16])
    argv = [data["fa"], path]
    if not torch.cuda.is_available():
        monkeypatch.delenv("BISCUIT_TPU_TORCH_ENGINE", raising=False)
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main_align(argv)
        monkeypatch.setenv("BISCUIT_TPU_TORCH_ENGINE", "device-jax")
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main_align(argv)
    for engine in ("native", "host"):
        monkeypatch.setenv("BISCUIT_TPU_TORCH_ENGINE", engine)
        assert cli.main_align(argv) == 0
    monkeypatch.delenv("BISCUIT_TPU_TORCH_ENGINE", raising=False)
    assert cli.main_align(["-v", "4", *argv]) == 0
    capsys.readouterr()
    monkeypatch.setenv("BISCUIT_TPU_TORCH_ENGINE", "native-jax")
    assert cli.main_align(argv) == 1
    assert "unknown engine 'native-jax'" in capsys.readouterr().err
