"""The command's refusals: no result without enough CUDA devices, none in
a directory that holds only BENCHMARK.json and h100bench/ (the port is not
there to import), and none once jax or the JAX package is loaded."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench.harness import ROOT

ARGS = ["--workload", "pure_vp.b100k", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def _command(cwd):
    return subprocess.run([sys.executable, "h100bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_jax_loaded_gives_no_result():
    pytest.importorskip("jax")
    code = (
        "import sys, time, json, torch; sys.path.insert(0, %r)\n"
        "import jax\n"
        "from h100bench.harness import run\n"
        "rc, res = run(%r, time.perf_counter(), device=torch.device('cpu'),\n"
        "              params={'rows': 16, 'reference_block': 16, 'check_rows': 16})\n"
        "print(json.dumps([rc, res]))\n" % (str(ROOT), ARGS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    rc, res = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc != 0 and res is None
    assert "jax" in out.stderr
