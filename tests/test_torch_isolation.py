"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, chip_smoke.py
refuses to report a result without a GPU, and the CLI round-trips.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dpsvm_tpu.data.synthetic import make_blobs, save_csv

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dpsvm_tpu_torch"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "dpsvm_tpu"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_matches_only_the_jax_side():
    assert _forbidden("jax.numpy") and _forbidden("dpsvm_tpu.config")
    assert not _forbidden("dpsvm_tpu_torch.config")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", ["native/__init__.py", "native/build.py",
                                 "observability/metrics.py",
                                 "data/stream.py", "data/convert.py",
                                 "data/scale.py", "data/__init__.py",
                                 "data/live.py", "serving/__init__.py",
                                 "serving/engine.py", "serving/batcher.py",
                                 "serving/budget.py", "serving/registry.py",
                                 "serving/sharded.py", "fleet/__init__.py",
                                 "fleet/packer.py", "fleet/modelcache.py",
                                 "fleet/grid.py"])
def test_the_host_layers_are_scanned_and_import_no_jax(rel):
    """The data, serving and fleet modules are among the scanned sources,
    and the native helper builds the port's own copy of the C++ source."""
    path = PORT / rel
    assert path in _sources()
    assert not [m for m in _imports(path) if _forbidden(m)]
    from dpsvm_tpu_torch.native import build
    assert build.SOURCE == PORT / "native" / "csv_loader.cpp"
    assert build.BUILD_DIR == PORT / "_build"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from dpsvm_tpu_torch import fit, train
    from dpsvm_tpu_torch.models.svm import decision_function
    x, y = make_blobs(n=40, d=3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(x, y)
    model, _ = fit(x, y, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decision_function(model, x)


def _run(args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd is tmp_path:
            (tmp_path / "chip_smoke.py").write_text(script.read_text())
            script = tmp_path / "chip_smoke.py"
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_cli_round_trip_and_jax_model(tmp_path, capsys):
    x, y = make_blobs(n=160, d=5, seed=6)
    train_csv, test_csv = str(tmp_path / "tr.csv"), str(tmp_path / "te.csv")
    save_csv(train_csv, x[:120], y[:120])
    save_csv(test_csv, x[120:], y[120:])
    model = str(tmp_path / "port.svm")
    tr = _run(["-m", "dpsvm_tpu_torch.cli", "train", "--device", "cpu",
               "-f", train_csv, "-m", model, "-c", "10", "-g", "0.2", "-q"])
    assert tr.returncode == 0, tr.stderr
    assert "Number of SVs:" in tr.stdout and "Training accuracy:" in tr.stdout
    te = _run(["-m", "dpsvm_tpu_torch", "test", "--device", "cpu",
               "-f", test_csv, "-m", model])
    assert te.returncode == 0, te.stderr
    port_acc = [ln for ln in te.stdout.splitlines()
                if ln.startswith("Test accuracy:")]

    # The JAX CLI on the port's file, and the port's CLI on a JAX file.
    from dpsvm_tpu.cli import main as jax_main
    assert jax_main(["test", "-f", test_csv, "-m", model]) == 0
    jax_out = capsys.readouterr().out
    assert port_acc and port_acc[0] in jax_out.splitlines()
    jmodel = str(tmp_path / "jax.svm")
    assert jax_main(["train", "-f", train_csv, "-m", jmodel, "-c", "10",
                     "-g", "0.2", "-q"]) == 0
    capsys.readouterr()
    assert jax_main(["test", "-f", test_csv, "-m", jmodel]) == 0
    jax_acc = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("Test accuracy:")]
    te2 = _run(["-m", "dpsvm_tpu_torch.cli", "test", "--device", "cpu",
                "-f", test_csv, "-m", jmodel])
    assert te2.returncode == 0, te2.stderr
    assert jax_acc and jax_acc[0] in te2.stdout.splitlines()


def test_cli_errors_are_clean(tmp_path):
    out = _run(["-m", "dpsvm_tpu_torch.cli", "test", "--device", "cpu",
                "-f", str(tmp_path / "missing.csv"), "-m", "x.svm"])
    assert out.returncode == 2 and "error:" in out.stderr
    if not torch.cuda.is_available():
        csv = tmp_path / "d.csv"
        csv.write_text("1,0.5\n-1,0.25\n")
        out = _run(["-m", "dpsvm_tpu_torch.cli", "train", "-f", str(csv),
                    "-m", str(tmp_path / "m.svm"), "-q"])
        assert out.returncode == 2 and "CUDA is not available" in out.stderr
        assert not (tmp_path / "m.svm").exists()

