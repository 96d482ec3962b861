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
