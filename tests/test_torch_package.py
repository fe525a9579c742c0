"""Package boundary of the port: importing it pulls in no JAX, and its
CLI writes the same solution files as the JAX package's CLI."""

import os
import shutil
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
            "bensolve_tpu_torch.lp.dual_simplex, bensolve_tpu_torch.convert, "
            "bensolve_tpu_torch.algs.many, "
            "bensolve_tpu_torch.parallel.distributed, "
            "bensolve_tpu_torch.parallel.mesh, "
            "bensolve_tpu_torch.io.checkpoint, bensolve_tpu_torch.io.plot, "
            "bensolve_tpu_torch.vlp.writer, bensolve_tpu_torch.bench, "
            "bensolve_tpu_torch.scale_many, bensolve_tpu_torch.slow_runner, "
            "bensolve_tpu_torch.ex09_probe, bensolve_tpu_torch.graft_entry; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'bensolve_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-I", "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_multiprocess_worker_leaves_jax_out(tmp_path):
    """The port's multi-process worker, run as a single process group of
    one, imports neither JAX nor the JAX package."""
    worker = os.path.join(ROOT, "tests", "torch_multiproc_worker.py")
    code = ("import runpy, socket, sys; sys.path.insert(0, sys.argv[1]); "
            "s = socket.socket(); s.bind(('localhost', 0)); "
            "port = s.getsockname()[1]; s.close(); "
            "sys.argv = [sys.argv[2], 'allgather', str(port), '1', '0', "
            "sys.argv[3]]; runpy.run_path(sys.argv[0], run_name='__main__'); "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'bensolve_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-I", "-c", code, ROOT, worker,
                          str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "allgather_0.npy").exists()


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


def _code_strings(path):
    """Every string constant of a module's code: docstrings left out."""
    import ast

    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_code_names_the_jax_package_path():
    """No module of the port builds a path into bensolve_tpu/ (its
    docstrings may name the JAX modules they port), and no native
    source includes a file from there."""
    pkg = os.path.join(ROOT, "bensolve_tpu_torch")
    bad = []
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in ("_build",
                                                        "__pycache__")]
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py"):
                bad += [(path, s) for s in _code_strings(path)
                        if s == "bensolve_tpu" or "bensolve_tpu/" in s]
            elif f.endswith((".cu", ".cuh", ".cpp", ".h")):
                bad += [(path, ln) for ln in open(path)
                        if ln.lstrip().startswith("#include")
                        and "bensolve_tpu" in ln]
    assert not bad, bad


def test_engine_builds_from_the_ports_own_source(tmp_path, monkeypatch):
    """The polytope engine compiles from bensolve_tpu_torch/native/
    poly_engine.cpp, a byte-identical copy of the JAX package's."""
    import subprocess as sp

    from bensolve_tpu_torch import native

    src = os.path.join(ROOT, "bensolve_tpu_torch", "native",
                       "poly_engine.cpp")
    assert os.path.abspath(native._SRC) == src
    with open(src, "rb") as a, open(os.path.join(
            ROOT, "bensolve_tpu", "native", "poly_engine.cpp"), "rb") as b:
        assert a.read() == b.read()
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the engine's pure-Python fallback runs")
    cmds = []
    real = sp.run

    def run(cmd, *a, **kw):
        cmds.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native, "_BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "_poly_engine.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("BENSOLVE_TPU_NO_NATIVE", raising=False)
    assert native.lib() is not None
    assert len(cmds) == 1 and src in cmds[0]


# The port's host modules that copy the JAX package's, and every line in
# which each copy differs from its source once "bensolve_tpu_torch" reads
# "bensolve_tpu" (difflib.ndiff: "- " the source's, "+ " the copy's).
HOST_COPIES = {
    "examples.py": [
        '- """The reference example problems as Python generators — the '
        'port of',
        '+ """The reference example problems as Python generators (a copy of',
        '+ bensolve_tpu/examples.py, so the port can build them without JAX).',
        '- the MATLAB scripts ex/example01.m .. example11.m, which form the',
        "- project's acceptance behavior matrix (SURVEY.md section 4).",
        '- the .vlp files instead.',
        '+ the .vlp files instead, from ``ex_dir``.  ``ALL`` holds the '
        'generators',
        '+ that need no file.',
        '- def example07() -> VLPProblem:',
        '+ def example07(ex_dir: str = REFERENCE_EX) -> VLPProblem:',
        '-     return read_vlp(f"{REFERENCE_EX}/ex07.vlp")',
        '+     return read_vlp(f"{ex_dir}/ex07.vlp")',
        '- def example09() -> VLPProblem:',
        '+ def example09(ex_dir: str = REFERENCE_EX) -> VLPProblem:',
        '-     return read_vlp(f"{REFERENCE_EX}/ex09.vlp")',
        '+     return read_vlp(f"{ex_dir}/ex09.vlp")',
        '- ALL = {f"example{i:02d}": fn for i, fn in enumerate(',
        '+ ALL = {fn.__name__: fn for fn in',
        '-     [example01, example02, example03, example04, example05, '
        'example06,',
        '+        [example01, example02, example03, example04, example05, '
        'example06,',
        '-      example07, example08, example09, example10, example11], '
        'start=1)}',
        '+         example08, example10, example11]}'],
    "vlp/problem.py": [],
    "vlp/reader.py": [],
    "poly/polytope.py": [
        "+ from bensolve_tpu import spans",
        '+     @spans.traced("poly", method="add_vertex")',
        '+     @spans.traced("poly", method="initial_approx")',
        '+     @spans.traced("poly", method="update_adjacency")',
        '+     @spans.traced("poly", method="chop")',
        '+     @spans.traced("poly", method="normalize_directions")',
        '+     @spans.traced("poly", method="check")',
        '+     @spans.traced("poly", method="swap")'],
    "algs/solution.py": [],
    "io/writers.py": [],
    "native/poly_engine.cpp": [],
    "io/checkpoint.py": [
        "+ The keys are those of ``bensolve_tpu/io/checkpoint.py``, which "
        "this",
        "+ module ports: a snapshot written by either package resumes in the",
        "+ other."],
    "vlp/writer.py": [
        "- comparable with the shipped examples.",
        "+ comparable with the shipped examples.  The port of",
        "+ ``bensolve_tpu/vlp/writer.py`` (host numpy code, unchanged)."],
    "io/plot.py": [
        "- records per-axis scaling.",
        "+ records per-axis scaling.  The port of ``bensolve_tpu/io/plot.py``",
        "+ (host numpy code, unchanged).",
        "+ ",
        "+ import os",
        "-     import os",
        "- "],
}


@pytest.mark.parametrize("path", sorted(HOST_COPIES))
def test_host_copies_hold_to_their_source(path):
    """Drift guard: a host module the port copies from the JAX package
    differs from its source only in the import rename and the lines
    listed in HOST_COPIES, so a fix to either side shows up here."""
    import difflib

    with open(os.path.join(ROOT, "bensolve_tpu_torch", path)) as f:
        port = f.read().replace("bensolve_tpu_torch", "bensolve_tpu")
    with open(os.path.join(ROOT, "bensolve_tpu", path)) as f:
        src = f.read()
    diff = [ln for ln in difflib.ndiff(src.splitlines(), port.splitlines())
            if ln[:2] in ("+ ", "- ")]
    assert diff == HOST_COPIES[path]
