"""The time limits of a run (loops.time_limit, loops.WARM_LIMIT_S,
loops.CHUNK_LIMIT_S): a block past its limit ends the process at once, also
inside a C call that holds the GIL; a block in time is cancelled; the loops
arm a limit around the warm chunk or call and each one of the window, and
only where run_cell is given limits, which the command alone gives."""
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import loops, run
from benchmark.tests.conftest import SIZES, bench

# each cell at the tests' sizes and the seconds of a window of a few chunks
# or calls (an align chunk of 5,000 bases takes some 3-4 s on the CPU)
CELLS = {"wgbs-pe150.align": (dict(SIZES, chunk_bases=5_000), 5.0),
         "rrbs-se100.align": (dict(SIZES, chunk_bases=5_000), 5.0),
         "wgbs-pe150.pileup": (SIZES, 1.5),
         "rrbs-se100.pileup": (dict(SIZES, pileup_region_bp=350_000), 1.5)}

BODIES = {"python_sleep": "time.sleep(60)",
          "c_call_holding_the_gil": "ctypes.PyDLL(None).sleep(60)"}


def _limited(body: str, after: str = ""):
    """A process that runs `body` under a 1 s limit, then `after`; it
    prints the clock as it arms the limit on stderr and "done" at its end
    on stdout."""
    code = f"""
import ctypes, sys, time
from benchmark import loops
print("armed at", time.time(), file=sys.stderr, flush=True)
with loops.time_limit(1, "cell-x.align window chunk 3", time.perf_counter()):
    {body}
{after}
print("done")
"""
    return subprocess.run([sys.executable, "-c", code], cwd=run.REPO,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("body", sorted(BODIES))
def test_bench_time_limit_stops_a_body_past_it(body):
    """Past its limit the process ends within the limit plus 5 s, exits
    non-zero, prints nothing on stdout, and stderr names the cell, the
    chunk and the limit and holds the stacks."""
    r = _limited(BODIES[body])
    ended = time.time()
    armed = float(r.stderr.split("armed at ")[1].split()[0])
    assert ended - armed < 1 + 5, r.stderr
    assert r.returncode != 0
    assert r.stdout == ""
    assert "cell-x.align window chunk 3: 1 s" in r.stderr
    assert "Timeout (0:00:01)!" in r.stderr
    assert "most recent call first" in r.stderr
    assert 'File "<string>", line 6 in <module>' in r.stderr


def test_bench_time_limit_is_cancelled_after_a_body_in_time():
    r = _limited("time.sleep(0.1)", after="time.sleep(2.5)")
    assert r.returncode == 0, r.stderr
    assert r.stdout == "done\n"
    assert "Timeout" not in r.stderr


class _Faulthandler:
    """faulthandler's arming and cancelling, recorded and not armed."""

    def __init__(self):
        self.calls = []

    def dump_traceback_later(self, timeout, repeat=False, file=None,
                             exit=False):
        self.calls.append(("arm", timeout, exit))

    def cancel_dump_traceback_later(self):
        self.calls.append(("cancel",))


def _window(res) -> int:
    """The chunks or calls of a run's window."""
    out = res["outputs"]
    return len(out["window"] if isinstance(out, dict) else out)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bench_loops_arm_a_limit_around_every_chunk_and_call(cell, cpu,
                                                             monkeypatch):
    """Given both limits, a loop arms the warm limit around its warm chunk
    or call and the chunk limit around each one of the window, and cancels
    each after it; the run comes out as it does without them."""
    fh = _Faulthandler()
    monkeypatch.setattr(loops, "faulthandler", fh)
    sizes, seconds = CELLS[cell]
    res = run.run_cell(cell, 41, seconds, False, cpu, bench(), sizes=sizes,
                       time_limits=(240, 60))
    assert res["correct"], res["checks"]
    n = _window(res)
    assert n >= 1
    assert fh.calls == [("arm", 240, True), ("cancel",)] + \
        [("arm", 60, True), ("cancel",)] * n


@pytest.mark.parametrize("cell", ["rrbs-se100.align", "wgbs-pe150.pileup"])
def test_bench_run_cell_without_limits_arms_nothing(cell, cpu, monkeypatch):
    fh = _Faulthandler()
    monkeypatch.setattr(loops, "faulthandler", fh)
    res = run.run_cell(cell, 42, 0.1, False, cpu, bench(),
                       sizes=CELLS[cell][0])
    assert res["correct"], res["checks"]
    assert fh.calls == []


def test_bench_command_gives_run_cell_both_limits(monkeypatch, capsys):
    """The command hands run_cell (WARM_LIMIT_S, CHUNK_LIMIT_S), each
    within what a check allows: the warm limit at most 300 s, the chunk
    limit under the 70 s a WGBS chunk takes on device-jax."""
    import torch
    got = {}

    def fake_run_cell(name, seed, seconds, trace, device, bench=None,
                      control=None, sizes=None, time_limits=None):
        got["time_limits"] = time_limits
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "memory_peak_bytes": 0, "checks": {}, "outputs": []}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "card", lambda: {"platform": "gpu", "kind": "x",
                                              "count": 1, "power_limit": "x"})
    monkeypatch.setattr(run, "run_cell", fake_run_cell)
    # the variables the command sets or deletes, restored after it
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(k, "")
    for k in [k for k in os.environ if k.startswith("BISCUIT_TPU")]:
        monkeypatch.setenv(k, os.environ[k])
    assert run.main(["--workload", "rrbs-se100.align", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert got["time_limits"] == (loops.WARM_LIMIT_S, loops.CHUNK_LIMIT_S)
    assert 0 < loops.CHUNK_LIMIT_S < 70 and \
        loops.CHUNK_LIMIT_S < loops.WARM_LIMIT_S <= 300
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "correct"]
