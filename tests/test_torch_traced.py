"""The port's span and counter registry (biscuit_tpu_torch/utils/spans.py)
and the hybrid's traced C++ stage (align/traced_host.cpp,
align/traced_native.py).

The port's batch entries of traced_host.cpp must write the SAM of the
copy's bt_align_se_batch and bt_align_pe_batch byte for byte, with the
device seeder's injection and without, on 1 and 4 threads, with the copy's
profiler slots driven (under a torch.profiler) and not; and their bodies
are the copy's, line for line, but for the lines marked `// trace` and the
copy's BT_PROF switch and report. Then the registry: spans, stages and
counters summed, what reset_stages() keeps, the keys its readers use, the
benchmark's readers of the spans on a traced chunk's report, the spans in
a CPU profiler's trace with their chunk id, and nothing entered or
switched on without a profiler.
"""
import importlib.util
import json
import os
import re
import time

import pytest
import torch

from biscuit_tpu_torch.align import device_engine as eng
from biscuit_tpu_torch.align import traced_native
from biscuit_tpu_torch.align.io_helpers import read_clipping
from biscuit_tpu_torch.align.native_engine import NativeAligner
from biscuit_tpu_torch.align.pipeline import AlignerState
from biscuit_tpu_torch.config import MEM_F_NO_MULTI, MEM_F_PE
from biscuit_tpu_torch.index.build import build_index
from biscuit_tpu_torch.pileup import engine as plp_engine
from biscuit_tpu_torch.utils import spans

from torch_testdata import (REPO, damage_mates, load_pairs, load_reads,
                            make_dataset, port_opt)

torch.set_num_threads(1)

N_SE, N_PAIRS = 64, 48


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """60 kbp, 64 SE reads of 100 bp with SNPs and an indel in two of every
    four, 48 pairs with every third mate 2 damaged (only rescue places it),
    one index, one CPU seeder and the injection of each layout's reads."""
    d = tmp_path_factory.mktemp("ttraced")
    fa, fq, _ = make_dataset(d, genome_size=60000, n_reads=N_SE, seed=13,
                             snp_rate=0.01, indel_every=4, index=False)
    pfa, fqs, _ = make_dataset(d / "pe", genome_size=60000, n_reads=N_PAIRS,
                               seed=13, snp_rate=0.01, pe=True, index=False)
    damage_mates(fqs[1], 3)
    st = AlignerState(build_index(fa, prefix=fa))
    pst = AlignerState(build_index(pfa, prefix=pfa))
    out = {"se": (st, lambda: load_reads(fq, N_SE)),
           "pe": (pst, lambda: load_pairs(*fqs))}
    for layout, (state, load) in list(out.items()):
        seqs = _clipped(load(), layout)
        inj = eng.DeviceSeeder(state, "cpu").build_injection(
            _opt(layout), seqs, layout == "pe")
        out[layout] = (state, load, inj)
    return out


def _opt(layout, threads=1):
    opt = port_opt(MEM_F_NO_MULTI | (MEM_F_PE if layout == "pe" else 0))
    opt.n_threads = threads
    return opt


def _clipped(seqs, layout):
    opt = _opt(layout)
    for s in seqs:
        read_clipping(s, opt.adaptor1 if (layout == "se" or s.id % 2 == 0)
                      else opt.adaptor2, opt)
    return seqs


def _batch(nat, layout, seqs, threads, inj):
    opt = _opt(layout, threads)
    if layout == "se":
        return nat.align_se_batch(opt, seqs, 0, "", threads, inj=inj)
    sams, pes = nat.align_pe_batch(opt, seqs, 0, "", threads, inj=inj)
    return sams, (pes.low, pes.high, pes.avg, pes.std)


@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profiled"])
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("injected", [False, True], ids=["self", "inj"])
@pytest.mark.parametrize("layout", ["se", "pe"])
def test_port_entries_write_the_copys_sam(data, layout, injected, threads,
                                          profiled):
    """bt_port_align_*_batch against the copy's bt_align_*_batch on the
    same marshalled reads: the same SAM byte for byte (and in PE the same
    insert-size statistics), each read's status the same; the phases and
    busy times recorded, the profiler slots only under a profiler."""
    st, load, inj = data[layout]
    nat = NativeAligner(st)
    want = _batch(nat, layout, _clipped(load(), layout), threads,
                  inj if injected else None)
    spans.reset_stages()
    traced = traced_native.TracedAligner(nat)
    seqs = _clipped(load(), layout)
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _batch(traced, layout, seqs, threads,
                         inj if injected else None)
    else:
        got = _batch(traced, layout, seqs, threads, inj if injected else None)
    assert got == want
    sams = got[0] if layout == "pe" else got
    assert sum(s is not None for s in sams) >= len(sams) - 2
    rep = spans.stage_report()
    phases = ("regions+sam",) if layout == "se" else ("regions", "pestat",
                                                      "pair")
    for ph in phases + ("concat",):
        assert rep[f"native.phase.{ph}"] > 0
    assert rep["native.threads"] == threads and rep["native.busy_cpu"] > 0
    assert rep["native.reads"] == len(seqs)
    assert rep["native.redo_reads"] == sum(s is None for s in sams)
    assert rep["native.call"] > sum(rep[f"native.phase.{ph}"]
                                    for ph in phases + ("concat",))
    assert ("native.busy.pair" in rep) == (layout == "pe")
    assert not any(k.startswith("native.busy.") and k != "native.busy.pair"
                   for k in rep)
    cpu = {k for k in rep if k.startswith("native.cpu.")}
    assert bool(cpu) == profiled
    if profiled:
        assert "native.cpu.extend" in cpu and "native.cpu.merge_regions" in cpu
        assert ("native.cpu.sa_walk" in cpu) == (not injected)
        assert ("native.cpu.worker2(sam)" in cpu) == (layout == "se")


def _entry_body(text, name):
    """The lines of C function `name` from its signature's second line to
    its closing brace."""
    lines = text.split("\n")
    i = next(k for k, ln in enumerate(lines) if ln.startswith(f"int {name}("))
    j = next(k for k in range(i, len(lines)) if lines[k] == "}")
    return lines[i + 1:j + 1]


@pytest.mark.parametrize("name", ["se", "pe"])
def test_port_entries_are_the_copys_line_for_line(name):
    """Each port entry is the copy's entry, argument for argument and line
    for line, but for its lines marked `// trace`; the copy's BT_PROF switch
    (six lines) and its prof_report line, only in the SE entry, are what the
    port leaves out."""
    with open(os.path.join(REPO, "biscuit_tpu_torch", "native",
                           "align_host.cpp")) as f:
        copy = _entry_body(f.read(), f"bt_align_{name}_batch")
    with open(os.path.join(REPO, "biscuit_tpu_torch", "align",
                           "traced_host.cpp")) as f:
        text = f.read()
    port = _entry_body(text, f"bt_port_align_{name}_batch")
    marked = [ln for ln in port if ln.endswith("  // trace")]
    assert len(marked) >= 6
    prof = [k for k, ln in enumerate(copy) if 'getenv("BT_PROF")' in ln]
    if name == "se":
        k, = prof
        assert copy[k - 1] == "    {" and copy[k + 4] == "    }"
        del copy[k - 1:k + 5]
        assert copy.count('    prof_report("se_batch");') == 1
        copy.remove('    prof_report("se_batch");')
    else:
        assert not prof and not any("prof_report" in ln for ln in copy)
    assert [ln for ln in port if not ln.endswith("  // trace")] == copy
    assert not re.search(r"getenv|fprintf|prof_report", text)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_spans_and_counters_sum_and_only_stages_make_total_s():
    """A span's walls sum under its name, an `add`ed span with them;
    `count` sums, `peak` keeps the largest, a declared counter reads 0
    before it is counted; `total_s` sums the stages alone."""
    spans.reset_stages()
    spans.declare("t.declared")
    with spans.span("t.outer"):
        time.sleep(0.02)
        for _ in range(2):
            with spans.span("t.inner"):
                time.sleep(0.01)
    spans.add("t.inner", 0.5)
    spans.count("t.n", 2)
    spans.count("t.n")
    spans.peak("t.peak", 3)
    spans.peak("t.peak", 2)
    rep = spans.stage_report()
    assert rep["t.outer"] >= 0.04
    assert 0.52 <= rep["t.inner"] < rep["t.outer"] + 0.5
    assert (rep["t.n"], rep["t.peak"], rep["t.declared"]) == (3, 3, 0)
    assert rep["total_s"] == 0.0  # no stage entered
    with spans.stage("t.stage"):
        time.sleep(0.01)
    rep = spans.stage_report()
    assert rep["total_s"] == rep["t.stage"] >= 0.01


def test_reset_keeps_the_setup_spans_and_the_lane_counts():
    """reset_stages() clears spans and counters but the `setup.` spans
    (the benchmark resets after its warm chunk) and puts every lane count
    back to 0; `total_s` sums the stages alone."""
    spans.reset_stages()
    with spans.span("setup.t_tables"):
        pass
    with spans.stage("inject"):
        with spans.span("inject.t_part"):
            pass
    spans.count("sa_rows", 5)
    spans.count("t.bytes", 7)
    rep = spans.stage_report()
    assert rep["total_s"] == rep["inject"] and rep["sa_rows"] == 5
    eng.reset_stages()
    rep = eng.stage_report()
    assert "setup.t_tables" in rep and "inject" not in rep and \
        "inject.t_part" not in rep and "t.bytes" not in rep
    assert {k: rep[k] for k in eng.LANE_COUNTS} == \
        dict.fromkeys(eng.LANE_COUNTS, 0)


def test_reports_keep_the_keys_their_readers_use(data):
    """stage_report() after a hybrid chunk holds every key that the
    benchmark, chip_smoke.py and the tests read: the stages entered, the
    lane counts, `total_s`; no `device_share`. pileup.engine.STAGES keeps
    its keys and their types, and its reset_stages clears it."""
    st, load, _inj = data["se"]
    spans.reset_stages()
    eng.process_seqs_hybrid(_opt("se"), st, load(), 0,
                            seeder=eng.DeviceSeeder(st, "cpu"))
    rep = eng.stage_report()
    assert {"inject", "native", "total_s", "setup.seeder_tables",
            *eng.LANE_COUNTS} <= set(rep)
    assert "device_share" not in rep
    assert rep["total_s"] == pytest.approx(rep["inject"] + rep["native"])
    assert rep["native"] >= rep["native.marshal"] + rep["native.call"] + \
        rep["native.collect"]
    assert {k: type(v) for k, v in plp_engine.STAGES.items()} == {
        "open": float, "decode": float, "count": float, "emit": float,
        "native": float, "windows": int, "raw_windows": int, "data": int,
        "sites": int, "wide_chunks": int}
    plp_engine.STAGES["windows"] += 3
    plp_engine.STAGES["count"] += 0.5
    plp_engine.reset_stages()
    assert plp_engine.STAGES["windows"] == 0 and \
        plp_engine.STAGES["count"] == 0.0


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("t_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    SPAN_METRICS = {m["name"]: m["unit"] for m in json.load(_f)["per_layer"]
                    if m["source"] == "program_span"
                    and "wgbs-pe150.align" in m["workloads"]}


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_benchmark_readers_split_a_traced_chunk(data, layout):
    """Every program_span reader of the align cells reads a number from
    the report of a chunk aligned under a CPU profiler, and the parts add
    up: `native`'s three spans inside it, the C++ engine's CPU shares and
    `inject`'s shares each at most 100%. Three read nothing on a CPU device
    and these data, and read their spans once they are there: a CPU seeder
    has no stream to wait on (`inject.wait_share`) and copies nothing from
    pageable memory (`inject.to_card_gbps`), and the seeder's rows hold
    every occurrence the C++ engine asks for (`native.sa_walk_cpu`; the
    engine walks SA itself when it seeds: see
    test_port_entries_write_the_copys_sam).
    On the parent's report, which has none of the parts, the new readers
    read nothing."""
    st, load, _inj = data[layout]
    spans.reset_stages()
    sdr = eng.DeviceSeeder(st, "cpu")
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.process_seqs_hybrid(_opt(layout, 2), st, load(), 0, seeder=sdr)
    ctx = {"stages": eng.stage_report(), "wall": time.perf_counter() - t0}
    got = {name: _reader(name)(ctx) for name in SPAN_METRICS}
    cpu_only = ("inject.wait_share", "inject.to_card_gbps",
                "native.sa_walk_cpu")
    assert [got.pop(k) for k in cpu_only] == [None] * 3
    assert all(v is not None and v >= 0 for v in got.values()), \
        {k: v for k, v in got.items() if v is None or v < 0}
    assert all(v <= 100 for k, v in got.items() if SPAN_METRICS[k] == "%")
    st_ = ctx["stages"]
    assert st_["native.marshal"] + st_["native.call"] + \
        st_["native.collect"] <= st_["native"]
    assert sum(got[k] for k in ("native.chain_cpu", "native.extend_cpu",
                                "native.sam_cpu")) <= 100
    assert sum(got[k] for k in ("inject.copy_share", "inject.launch_share",
                                "inject.group_share")) <= 100
    parent = {"inject": 0.5, "native": 1.0, "total_s": 1.5,
              "device_share": 0.3, **dict.fromkeys(eng.LANE_COUNTS, 0)}
    new = [k for k in SPAN_METRICS if not k.startswith("hybrid.")]
    assert len(new) == 16
    assert all(_reader(k)({"stages": parent, "wall": 2.0}) is None
               for k in new)
    ctx["stages"] = dict(st_, **{"inject.pageable_bytes": 3e9,
                                 "inject.to_card": 1.5,
                                 "inject.wait": st_["inject"] / 4,
                                 "native.cpu.sa_walk":
                                     st_["native.busy_cpu"] / 5})
    assert _reader("inject.to_card_gbps")(ctx) == pytest.approx(2.0)
    assert _reader("inject.wait_share")(ctx) == pytest.approx(25.0)
    assert _reader("native.sa_walk_cpu")(ctx) == pytest.approx(20.0)


@pytest.mark.parametrize("layout", ["se", "pe"])
def test_profiler_trace_holds_the_spans_with_their_chunk(data, layout,
                                                         tmp_path):
    """Under a CPU torch.profiler the exported Chrome trace holds
    `bt.native.call` and `bt.inject.*` events, each named with its chunk's
    first read number, and the C++ slots ran."""
    st, load, _inj = data[layout]
    spans.reset_stages()
    sdr = eng.DeviceSeeder(st, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.process_seqs_hybrid(_opt(layout, 2), st, load(), 4000,
                                seeder=sdr)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("name", "").startswith("bt.")]
    parsed = {tuple(n.split("#")) for n in names}
    assert all(len(p) == 2 and p[1] == "4000" for p in parsed), parsed
    got = {p[0] for p in parsed}
    assert {"bt.native.call", "bt.native.marshal", "bt.native.collect",
            "bt.native", "bt.clip", "bt.inject", "bt.inject.lanes",
            "bt.inject.to_card", "bt.inject.seed", "bt.inject.group",
            "bt.inject.sa", "bt.inject.arrays"} <= got
    assert spans.stage_report()["native.cpu.extend"] > 0


def test_injector_thread_spans_reach_a_trace_of_all_threads(data, tmp_path,
                                                           monkeypatch):
    """SE sub-batches pipelined (DEVICE_BATCH 16): the injector thread's
    `clip` and `inject.*` spans reach the registry, and the trace of a
    profiler made to record all threads, beside the main thread's
    `native.*` spans, all under the chunk's first read number."""
    st, load, _inj = data["se"]
    monkeypatch.setattr(eng, "DEVICE_BATCH", 16)
    spans.reset_stages()
    sdr = eng.DeviceSeeder(st, "cpu")
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        eng.process_seqs_hybrid(_opt("se", 2), st, load(), 700, seeder=sdr)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("bt.")]
    tids = {e["name"].split("#")[0]: e["tid"] for e in events}
    assert {e["name"].split("#")[1] for e in events} == {"700"}
    assert tids["bt.inject.seed"] == tids["bt.clip"] != tids["bt.native.call"]
    n = lambda name: sum(e["name"] == name + "#700" for e in events)
    assert n("bt.clip") == n("bt.inject") == n("bt.native.call") == N_SE // 16


def test_without_a_profiler_nothing_is_recorded_or_switched_on(
        data, monkeypatch, capfd):
    """With no profiler no record_function is entered, the C++ slots stay
    off even with BT_PROF set (the port's entries never read it) and
    nothing reaches stderr from the C++ engine."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setenv("BT_PROF", "2")
    st, load, _inj = data["pe"]
    spans.reset_stages()
    assert not spans.profiling()
    eng.process_seqs_hybrid(_opt("pe", 2), st, load(), 0,
                            seeder=eng.DeviceSeeder(st, "cpu"))
    rep = eng.stage_report()
    assert rep["native.call"] > 0 and rep["native.busy_cpu"] > 0
    assert not any(k.startswith("native.cpu.") for k in rep)
    assert not re.search(r"BT_PROF|\[bt\]", capfd.readouterr().err)
    assert not traced_native.take()[traced_native.TR_SLOTS:].any()
