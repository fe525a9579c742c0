"""Package boundary of the port: importing it pulls in no JAX, and its
CLI writes the same solution files as the JAX package's CLI."""

import os
import subprocess
import sys

import pytest
import torch

from bensolve_tpu import __main__ as jax_cli
from bensolve_tpu import examples
from bensolve_tpu.vlp.writer import write_vlp
from bensolve_tpu_torch import __main__ as torch_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_import_leaves_jax_out():
    # -I: no user site and no PYTHON* variables, so nothing but the
    # package itself can import modules
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import bensolve_tpu_torch, bensolve_tpu_torch.examples, "
            "bensolve_tpu_torch.lp.group_simplex, "
            "bensolve_tpu_torch.lp.dual_simplex, bensolve_tpu_torch.convert; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'bensolve_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-I", "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("name", ["example01", "example08"])
def test_cli_writes_the_same_solution_files(name, tmp_path, capsys):
    src = tmp_path / f"{name}.vlp"
    write_vlp(getattr(examples, name)(), str(src))
    base_j, base_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main([str(src), "-o", base_j, "-m", "0"]) == 0
    assert torch_cli.main([str(src), "-o", base_t, "-m", "0",
                           "--device", "cpu"]) == 0
    for suffix in ("_img_p.sol", "_img_d.sol"):
        with open(base_j + suffix) as fj, open(base_t + suffix) as ft:
            assert ft.read() == fj.read(), suffix


def test_cli_output_name_keeps_dotted_directories(tmp_path):
    """The default output name strips only the extension
    (os.path.splitext), not everything after the first dot."""
    folder = tmp_path / "run.v1"
    folder.mkdir()
    src = folder / "ex01.vlp"
    write_vlp(examples.example01(), str(src))
    assert torch_cli.main([str(src), "-m", "0", "--device", "cpu"]) == 0
    assert (folder / "ex01_img_p.sol").exists()
