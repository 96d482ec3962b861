"""The port's sharded drivers and the switches they steer (K10's host side),
vs the port's one-process runs and the JAX package's drivers, on the CPU.

`python -m biscuit_tpu_torch.tools.shard_align -n 2` must write the SAM of
the port's one-process `align` (the body: the merge drops @PG) and the
bytes of the JAX package's tools/shard_align.py on the same data, SE, PE
with two FASTQs (through the insert-size exchange, BISCUIT_TPU_TORCH_PES_
EXCHANGE), interleaved pairs under -p (a stride of pair groups,
BISCUIT_TPU_TORCH_FASTQ_STRIDE) and a `-` source spooled once.
`shard_pileup -n 2` must write the VCF (without ##program, which holds the
command) and _meth_average.tsv of one `pileup`, and those of the JAX
package's driver; BISCUIT_TPU_TORCH_MA_RAW's JSON must be the bytes of the
JAX CLI's BISCUIT_TPU_MA_RAW; `pileup` under BISCUIT_TPU_TORCH_PILEUP=mesh
on 2 gloo ranks started with torchrun's variables must write, from rank 0
alone, the VCF of a one-process run. The data come from
tools/make_testdata.py and the port's own `index`, `align` and `sort`.
"""
import os
import socket
import subprocess
import sys

import pytest

from torch_testdata import REPO, cli_env, make_dataset, run_cli


def _jax_env(**more):
    """cli_env() without BISCUIT_TPU_PLATFORM, which makes biscuit_tpu
    import jax on start: its native engines use no jax."""
    env = cli_env(**more)
    env.pop("BISCUIT_TPU_PLATFORM", None)
    return env


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{name: path}: an SE sample of 2 chromosomes (fa, fq) with its sorted,
    indexed BAM (bam) and the VCF of one `pileup` of it (one), and a PE
    sample of 1 chromosome (pe_fa, fq1, fq2) with its mates interleaved in
    one file (il)."""
    d = tmp_path_factory.mktemp("tdrv")
    fa, fq, _ = make_dataset(d / "se", genome_size=40000, n_reads=240,
                             n_chroms=2, seed=17)
    pe_fa, (fq1, fq2), _ = make_dataset(d / "pe", genome_size=40000,
                                        n_reads=150, n_chroms=1, seed=31,
                                        pe=True)
    il = str(d / "pe" / "il.fq")
    with open(fq1) as a, open(fq2) as b, open(il, "w") as f:
        r1, r2 = a.read().splitlines(), b.read().splitlines()
        for i in range(0, len(r1), 4):
            f.write("\n".join(r1[i:i + 4] + r2[i:i + 4]) + "\n")
    sam, bam = str(d / "se" / "aln.sam"), str(d / "se" / "aln.bam")
    with open(sam, "w") as f:
        f.write(run_cli("biscuit_tpu_torch", ["align", fa, fq],
                        BISCUIT_TPU_TORCH_ENGINE="native").stdout)
    run_cli("biscuit_tpu_torch", ["sort", "-o", bam, sam])
    run_cli("biscuit_tpu_torch", ["bamindex", bam])
    one = str(d / "one.vcf")
    run_cli("biscuit_tpu_torch", ["pileup", "-o", one, fa, bam])
    return dict(fa=fa, fq=fq, bam=bam, pe_fa=pe_fa, fq1=fq1, fq2=fq2, il=il,
                one=one)


def _start(argv, env, stdin=None):
    """A subprocess from the repository's root, its stdin read from the
    file `stdin` names."""
    with open(stdin or os.devnull, "rb") as f:
        return subprocess.Popen(argv, cwd=REPO, env=env, stdin=f,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)


def _wait(*procs):
    """The stdout of each process, which must exit 0, run side by side."""
    outs = []
    for p in procs:
        so, se = p.communicate(timeout=600)
        assert p.returncode == 0, (p.args, se.decode()[-3000:])
        outs.append(so)
    return outs


def _body(sam: bytes):
    return [ln for ln in sam.decode().splitlines() if not ln.startswith("@")]


# case -> (align arguments after the reference, the FASTQ given on stdin,
# the port's engine): its default (the hybrid, plain K3 here) on SE and its
# native engine on the others (BISCUIT_TPU_TORCH_ENGINE)
ALIGN_CASES = {"se": (["fq"], None, "device"),
               "pe": (["fq1", "fq2"], None, "native"),
               "smart": (["-p", "il"], None, "native"),
               "spooled": (["-"], "fq", "native")}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_shard_align_equals_one_process_and_the_jax_driver(data, case):
    args, stdin, engine = ALIGN_CASES[case]
    fa = data["pe_fa" if case in ("pe", "smart") else "fa"]
    flags = [a for a in args if a.startswith("-") and a != "-"]
    files = [data[a] if a in data else a for a in args if a not in flags]
    feed = data[stdin] if stdin else None
    env = cli_env(BISCUIT_TPU_TORCH_ENGINE=engine)
    one_files = [data[stdin]] if stdin else files
    one, port, jax = _wait(
        _start([sys.executable, "-m", "biscuit_tpu_torch.cli", "align",
                *flags, fa, *one_files], env),
        _start([sys.executable, "-m", "biscuit_tpu_torch.tools.shard_align",
                "-n", "2", *flags, fa, *files], env, feed),
        _start([sys.executable, os.path.join(REPO, "tools", "shard_align.py"),
                "-n", "2", *flags, fa, *files], _jax_env(), feed))
    assert port == jax
    assert _body(port) == _body(one) and len(_body(one)) >= 240
    assert b"@PG" not in port and port.startswith(b"@SQ")


def _vcf_body(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("##program")]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_shard_pileup_equals_one_process_and_the_jax_driver(data, tmp_path):
    fa, bam, one = data["fa"], data["bam"], data["one"]
    port, jax = str(tmp_path / "port.vcf"), str(tmp_path / "jax.vcf")
    _wait(_start([sys.executable, "-m", "biscuit_tpu_torch.tools.shard_pileup",
                  "-n", "2", "-o", port, fa, bam], cli_env()),
          _start([sys.executable, os.path.join(REPO, "tools",
                                               "shard_pileup.py"),
                  "-n", "2", "-o", jax, fa, bam], _jax_env()))
    assert _vcf_body(port) == _vcf_body(one) == _vcf_body(jax)
    assert len(_vcf_body(one)) > 100
    for k in (port, jax):
        assert _read(k + "_meth_average.tsv") == \
            _read(one + "_meth_average.tsv")


def test_ma_raw_equals_the_jax_cli(data, tmp_path):
    """The raw per-chromosome accumulators: the port's switch gives the JAX
    CLI's bytes, and neither package reads the other's switch."""
    fa, bam = data["fa"], data["bam"]
    port, jax = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    _wait(_start([sys.executable, "-m", "biscuit_tpu_torch.cli", "pileup",
                  "-o", str(tmp_path / "p.vcf"), fa, bam],
                 cli_env(BISCUIT_TPU_TORCH_MA_RAW=port,
                         BISCUIT_TPU_MA_RAW=jax + ".x")),
          _start([sys.executable, "-m", "biscuit_tpu.cli", "pileup", "-o",
                  str(tmp_path / "j.vcf"), fa, bam],
                 _jax_env(BISCUIT_TPU_MA_RAW=jax,
                          BISCUIT_TPU_TORCH_MA_RAW=port + ".x")))
    assert _read(port) == _read(jax) and b'"chr2"' in _read(port)
    assert not os.path.exists(port + ".x") and not os.path.exists(jax + ".x")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_pileup_mesh_on_two_ranks_writes_the_one_process_vcf(data, tmp_path):
    """Two ranks of `pileup` under the mesh engine, as torchrun starts them
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), both told to
    write the same files: rank 0 writes the VCF and stats of one process,
    rank 1 nothing; each says it joined over gloo."""
    fa, bam, one = data["fa"], data["bam"], data["one"]
    out = str(tmp_path / "mesh.vcf")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "biscuit_tpu_torch.cli", "pileup", "-o", out,
         fa, bam], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=cli_env(BISCUIT_TPU_TORCH_PILEUP="mesh", WORLD_SIZE="2",
                    RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port)))
        for r in range(2)]
    res = [p.communicate(timeout=600) for p in procs]
    for r, (p, (so, se)) in enumerate(zip(procs, res)):
        assert p.returncode == 0, se.decode()[-3000:]
        assert so == b""
        assert f"[main_pileup] mesh: rank {r} of 2, backend gloo, device " \
            "cpu" in se.decode()
    assert _vcf_body(out) == _vcf_body(one) and len(_vcf_body(one)) > 100
    assert _read(out + "_meth_average.tsv") == _read(one + "_meth_average.tsv")


def test_pileup_mesh_of_one_process(data, tmp_path):
    """Without torchrun's variables the mesh is this process alone: the VCF
    of the device engine, no process group."""
    fa, bam, one = data["fa"], data["bam"], data["one"]
    out = str(tmp_path / "mesh.vcf")
    r = run_cli("biscuit_tpu_torch", ["pileup", "-o", out, fa, bam],
                BISCUIT_TPU_TORCH_PILEUP="mesh")
    assert "rank 0 of 1, backend none (one rank)" in r.stderr
    assert _vcf_body(out) == _vcf_body(one)


@pytest.mark.parametrize("launched", [{}, {"smem_seed": 2, "sa_walk": 0,
                                           "sa_walk_intervals": 1}])
def test_a_run_names_the_kernels_it_launched(monkeypatch, capsys, launched):
    """`align` and `pileup` end with one stderr line of the kernels they
    launched (what chip_smoke.py reads from the drivers' processes), and
    with none where nothing launched, as on the CPU."""
    from biscuit_tpu_torch import cli, kernels
    monkeypatch.setattr(kernels, "LAUNCHES", dict(launched))
    cli.report_launches("main_align")
    err = capsys.readouterr().err
    if any(launched.values()):
        assert err == ('[main_align] kernel launches: {"sa_walk_intervals": '
                       '1, "smem_seed": 2}\n')
    else:
        assert err == ""
