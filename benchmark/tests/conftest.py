"""CPU tests of the benchmark, and one marked `chip` that needs the card.

    python -m pytest benchmark/tests -q              # here: the chip test skips
    python -m pytest benchmark/tests -q -m chip      # on the card

The CPU tests run the cells at small sizes on the port's plain torch
versions of the kernels (BISCUIT_TPU_TORCH_DEVICE=cpu)."""
import pytest

# the small sizes of the CPU runs: a 2 Mbp genome, chunks of 60,000 bases,
# pileup over 20 kbp
SIZES = {"genome_bp": 2_000_000, "chunk_bases": 60_000, "pool_chunks": 2,
         "check_reads": 4000, "threads": 2, "pileup_region_bp": 20_000,
         "region_start": 100_000, "pool_bams": 2}


# the pileup cells as cells of the tests' own: BENCHMARK.json holds neither
# (their runs on the card spread past the largest bound, PERF.md section 7);
# their entries, ready to be added back, are held/pileup.json
def bench() -> dict:
    """BENCHMARK.json with the entries of held/pileup.json added: the
    pileup cells, pileup_sites_per_s and the pileup readers."""
    from benchmark import run
    b = run.load_json(run.REPO, "BENCHMARK.json")
    held = run.load_json(run.BENCH_DIR, "held", "pileup.json")
    for kind, entries in held.items():
        have = {e["name"]: e for e in b[kind]}
        for e in entries:
            if e["name"] not in have:
                b[kind].append(e)
            elif "workloads" in e:
                have[e["name"]]["workloads"] = sorted(
                    set(have[e["name"]]["workloads"]) | set(e["workloads"]))
    return b


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: pytest -m chip)")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu(monkeypatch):
    """The CPU as the program's device (its plain kernel versions)."""
    import torch
    monkeypatch.setenv("BISCUIT_TPU_TORCH_DEVICE", "cpu")
    for k in ("BISCUIT_TPU_TORCH_ENGINE", "BISCUIT_TPU_TORCH_PILEUP",
              "BISCUIT_TPU_WIDE_INDEX"):
        monkeypatch.delenv(k, raising=False)
    return torch.device("cpu")
