"""BENCHMARK.json against the files it names and the names' rules, the
generators' repeatability, the import rule, the trace reading, and the run
that needs the card."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run, trace
from benchmark.gen import genome as gmod
from benchmark.gen import reads as rmod
from benchmark.tests.conftest import SIZES, bench

BENCH = run.load_json(run.REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("with_held", [False, True])
def test_bench_names_resolve_to_files_and_keep_the_rules(with_held):
    """BENCHMARK.json, and with it the entries held out of it
    (held/pileup.json), keep the contract's keys, names and files."""
    bj = bench() if with_held else BENCH
    assert set(bj) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert bj["paths"] == ["benchmark"]
    for kind, keys in KEYS.items():
        for e in bj[kind]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in bj["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = run.load_json(run.REPO, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and not re.search(r"[\t\n]", text)
    for w in bj["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for part in ("configs/" + w["config"], "traffic/" + w["traffic"],
                     "limits/" + w["name"]):
            assert os.path.exists(os.path.join(run.BENCH_DIR, part + ".json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        limits = run.load_json(run.BENCH_DIR, "limits", w["name"] + ".json")
        assert set(limits) == {"limits", "control"}
    reported = {w["name"]: {m["name"] for m in bj["end_to_end"]
                            if w["name"] in m.get("workloads", [w["name"]])}
                for w in bj["workloads"]}
    for m in bj["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in bj["per_layer"]:
        assert os.path.exists(os.path.join(run.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        for w in m["workloads"]:
            assert m["moves"] in reported[w]
    for w, names in reported.items():
        assert "setup_s" in names and len(names) >= 2


def test_bench_generators_repeat_for_a_seed_and_differ_across_seeds():
    _b, _c, cfg, _m = run.cell_files("wgbs-pe150.align", sizes=SIZES)
    a, b = gmod.make_reference(cfg), gmod.make_reference(cfg)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    other = gmod.make_reference(dict(cfg, genome_seed=cfg["genome_seed"] + 1))
    assert not np.array_equal(a[0], other[0])
    g, _ = gmod.load_genome(cfg)
    for cell in ("wgbs-pe150.align", "rrbs-se100.align"):
        _b, _c, c, _m = run.cell_files(cell, sizes=SIZES)
        one = rmod.make_chunks(g, c, 5, 2, c["chunk_bases"])
        again = rmod.make_chunks(g, c, 5, 2, c["chunk_bases"])
        two = rmod.make_chunks(g, c, 6, 2, c["chunk_bases"])
        for x, y in zip(one, again):
            assert x.names == y.names and all(
                np.array_equal(s, t) for s, t in zip(x.seqs, y.seqs))
            assert np.array_equal(x.pos, y.pos)
        assert not all(np.array_equal(s, t) for s, t in
                       zip(one[0].seqs, two[0].seqs))
    _b, _c, c, m = run.cell_files("wgbs-pe150.pileup", bench(),
                                   sizes=SIZES)
    reg = (0, m["region_start"], m["region_start"] + c["pileup_region_bp"])
    p1, p2, p3 = (rmod.pileup_records(g, c, reg, 10, s, "t")
                  for s in (5, 5, 6))
    assert [(r.pos, r.seq.tobytes()) for r in p1] == \
        [(r.pos, r.seq.tobytes()) for r in p2]
    assert [r.seq.tobytes() for r in p1] != [r.seq.tobytes() for r in p3]


def test_bench_loads_neither_jax_nor_the_jax_package(tmp_path):
    """What a run loads, the reference and every metric reader with it, has
    no top-level module named jax, jaxlib, flax or biscuit_tpu (the port's
    name begins with the JAX package's: names are compared whole)."""
    code = f"""
import json, os, sys, torch
os.environ["BISCUIT_TPU_TORCH_DEVICE"] = "cpu"
from benchmark import run, control, loops
sizes = {json.dumps(SIZES)}
from benchmark.tests.conftest import bench
for cell in ("wgbs-pe150.align", "wgbs-pe150.pileup"):
    run.run_cell(cell, 31, 0.1, True, torch.device("cpu"), bench(),
                 sizes=sizes)
run.run_cell("rrbs-se100.pileup", 31, 0.1, True, torch.device("cpu"),
             bench(), sizes=dict(sizes, pileup_region_bp=350_000))
for m in bench()["per_layer"]:
    run.metric_reader(m["name"])
print(json.dumps(run.forbidden_modules()))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] == "biscuit_tpu_torch")[:3]))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=run.REPO,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    bad, port = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert bad == [] and port  # the port was loaded, JAX was not


def test_bench_run_without_the_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "wgbs-pe150.align", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=run.REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs 1 CUDA card" in r.stderr


def test_bench_trace_summary_and_readers():
    """The device's busy time is the union of its activity inside the
    window; idle gaps are named by the harness span around them; each
    reader finds its number, or nothing where the trace holds none."""
    ev = [{"ph": "X", "name": "benchmark.window", "ts": 0, "dur": 1000,
           "cat": "user_annotation"},
          {"ph": "X", "name": "benchmark.align_chunk", "ts": 0, "dur": 600,
           "cat": "user_annotation"},
          {"ph": "X", "name": "smem_seed_kernel<long, 12>", "ts": 100,
           "dur": 100, "cat": "kernel"},
          {"ph": "X", "name": "sa_walk_kernel<true, true>", "ts": 150,
           "dur": 100, "cat": "kernel"},
          {"ph": "X", "name": "Memcpy DtoH", "ts": 900, "dur": 200,
           "cat": "gpu_memcpy"}]
    s = trace.summarise(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["breakdown"]["idle_gaps"][0] == ["benchmark.align_chunk",
                                              pytest.approx(650e-6)]
    assert s["breakdown"]["device_ops"][0][0].startswith("smem_seed")
    ctx = {"trace": s, "wall": 1e-3, "lane_bases": 10_000, "row_bytes": 48,
           "stages": {"sa_rows": 100, "sa_jobs": 300, "inject": 2e-4,
                      "native": 7e-4},
           "spans": {"read": 1e-4, "write": 1e-4}, "chunk_s": [1e-3]}
    got = {m["name"]: run.metric_reader(m["name"])(ctx)
           for m in BENCH["per_layer"] if "pileup" not in m["name"]
           and m["name"] != "k9_roofline"}
    assert got["device.idle_share.align"] == pytest.approx(75.0)
    assert 0 < got["k3_roofline"] < 100
    assert 0 < got["k4_roofline"] < 100
    ctx["trace"] = None
    assert run.metric_reader("k3_roofline")(ctx) is None
    assert run.metric_reader("device.idle_share.align")(ctx) is None


def test_bench_pileup_stage_readers():
    """The pileup stages' shares of the window and the cost of a window
    with data; nothing where no window held data."""
    ctx = {"wall": 10.0, "stages": {"open": 1.0, "decode": 2.0,
                                    "count": 0.5, "emit": 1.5, "windows": 40,
                                    "raw_windows": 40}}
    got = {n: run.metric_reader(n)(ctx) for n in (
        "pileup.open_share", "pileup.decode_share", "pileup.emit_share",
        "pileup.window_ms", "pileup.count_share", "pileup.host_share")}
    assert got == pytest.approx({
        "pileup.open_share": 10.0, "pileup.decode_share": 20.0,
        "pileup.emit_share": 15.0, "pileup.window_ms": 100.0,
        "pileup.count_share": 5.0, "pileup.host_share": 45.0})
    ctx["stages"]["windows"] = 0
    assert run.metric_reader("pileup.window_ms")(ctx) is None


@pytest.mark.chip
def test_bench_cells_run_on_the_card(card):
    """Each cell runs once on the card, traced, and comes out correct with
    the card's numbers."""
    for w in BENCH["workloads"]:
        r = subprocess.run([sys.executable, "-m", "benchmark.run",
                            "--workload", w["name"], "--seed", "2147483999",
                            "--seconds", "2", "--trace", "1"], cwd=run.REPO,
                           capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
