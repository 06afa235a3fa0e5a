"""The port's native host helpers (``dpsvm_tpu_torch/native``) and what
runs on them: the CSV and libsvm loaders (``data/loader.py``), the
converters (``data/convert.py``) and svm-scale (``data/scale.py``), on the
CPU, against the JAX package.

Bars, and why: every one is exact, because both packages parse and print
with the same C and NumPy routines.

* parsed arrays bitwise equal to the JAX loaders' (CSV and libsvm, with
  the ``-x`` / ``-a`` overrides), through the native path and through the
  Python fallback (no compiler: ``native.build``'s compiler lookup
  monkeypatched away, a fresh build directory);
* malformed files raise the JAX messages; one difference is deliberate: a
  non-numeric CSV field gets the line number before NumPy's message (the
  port's earlier loader named the line; the JAX fallback does not);
* model files (written and read in Python by the port) byte for byte the
  JAX writer's, its native one and its fallback, for the reference RBF
  layout and the extended layouts (kernel header, task line, svidx); files
  read back to the same arrays either way;
* converted CSVs, scaled CSVs and ``.range`` files byte for byte JAX's;
* ``native.last_path()`` names the path each data load took, and the
  library is the port's own build of its own copy of the C++ source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from dpsvm_tpu.data import convert as jconvert
from dpsvm_tpu.data import loader as jloader
from dpsvm_tpu.data import scale as jscale
from dpsvm_tpu.data.synthetic import make_blobs, make_planted, save_csv
from dpsvm_tpu.models import io as jio
from dpsvm_tpu.models.svm import SVMModel as JModel
from dpsvm_tpu_torch import native
from dpsvm_tpu_torch.convert import model_from_numpy
from dpsvm_tpu_torch.data import convert as tconvert
from dpsvm_tpu_torch.data import loader as tloader
from dpsvm_tpu_torch.data import scale as tscale
from dpsvm_tpu_torch.models import io as tio
from dpsvm_tpu_torch.native import build as nbuild

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The fallback: no C++ compiler and no library built before."""
    monkeypatch.setattr(nbuild, "_compiler", lambda: None)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    nbuild.reset()
    assert native.load_native_lib() is None
    yield
    nbuild.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    base = tmp_path_factory.mktemp("native")
    x, y = make_planted(300, 40, 0.25, seed=5)
    x[x < 0.3] = 0.0                        # sparse-ish libsvm rows
    x[7] = 0.0                              # a label-only libsvm line
    csv, lib = str(base / "d.csv"), str(base / "d.libsvm")
    save_csv(csv, x, y)
    with open(lib, "w") as fh:
        fh.write("# a comment\n\n")
        for i in range(len(y)):
            toks = " ".join(f"{j + 1}:{repr(float(x[i, j]))}"
                            for j in np.flatnonzero(x[i]))
            fh.write(f"{int(y[i])} {toks}".rstrip() + "\n")
    reg = str(base / "reg.libsvm")
    with open(reg, "w") as fh:
        for i in range(50):
            fh.write(f"{0.25 * i - 3.125} 1:{float(x[i, 0])!r} "
                     f"3:{float(x[i, 2])!r}\n")
    return {"x": x, "y": y, "csv": csv, "libsvm": lib, "reg": reg,
            "base": base}


SHAPES = [dict(), dict(num_examples=120), dict(num_attributes=25),
          dict(num_examples=40, num_attributes=12)]
# -a wider than the file: libsvm pads with zeros (a CSV row would be short)
CASES = ([("csv", kw) for kw in SHAPES]
         + [("libsvm", kw) for kw in SHAPES + [dict(num_attributes=55)]])


@pytest.mark.parametrize("fmt,kw", CASES, ids=lambda v: v if isinstance(
    v, str) else ",".join(f"{a}={b}" for a, b in v.items()) or "file-shape")
def test_native_parse_is_bitwise_the_jax_one(files, fmt, kw):
    load_t = tloader.load_csv if fmt == "csv" else tloader.load_libsvm
    load_j = jloader.load_csv if fmt == "csv" else jloader.load_libsvm
    xt, yt = load_t(files[fmt], **kw)
    assert native.last_path() == "native"
    xj, yj = load_j(files[fmt], **kw)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert xt.dtype == np.float32 and yt.dtype == yj.dtype == np.int32


@pytest.mark.parametrize("fmt", ["csv", "libsvm"])
@pytest.mark.parametrize("kw", SHAPES, ids=["file-shape", "x", "a", "x-a"])
def test_fallback_equals_native(files, fmt, kw, request):
    load = tloader.load_csv if fmt == "csv" else tloader.load_libsvm
    xn, yn = load(files[fmt], **kw)
    assert native.last_path() == "native"
    request.getfixturevalue("no_compiler")
    xp, yp = load(files[fmt], **kw)
    assert native.last_path() == "python"
    np.testing.assert_array_equal(xn, xp)
    np.testing.assert_array_equal(yn, yp)


def test_float_labels_take_python_for_csv_and_native_for_libsvm(files):
    xt, yt = tloader.load_csv(files["csv"], float_labels=True)
    assert native.last_path() == "python"
    xj, yj = jloader.load_csv(files["csv"], float_labels=True)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    xt, yt = tloader.load_libsvm(files["reg"], float_labels=True)
    assert native.last_path() == "native"
    xj, yj = jloader.load_libsvm(files["reg"], float_labels=True)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert yt.dtype == np.float32


CSV_BAD = {
    "short-row": "1,0.5,0.25\n-1,0.1\n",
    "empty": "\n\n",
    "nan": "1,0.5,0.25\n-1,0.1,nan\n",
    "inf": "1,0.5,0.25\n-1,-inf,0.1\n",
}


@pytest.mark.parametrize("case", sorted(CSV_BAD))
def test_csv_errors_match_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.csv")
    with open(path, "w") as fh:
        fh.write(CSV_BAD[case])
    msgs = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError) as e:
            mod.load_csv(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw,what", [
    (dict(num_examples=5), "expected 5 rows, found 2"),
    (dict(num_examples=4, num_attributes=2), "expected 4 rows, found 2"),
])
def test_csv_shape_errors_match_jax(tmp_path, kw, what):
    path = str(tmp_path / "short.csv")
    with open(path, "w") as fh:
        fh.write("1,0.5,0.25\n-1,0.1,0.2\n")
    msgs = []
    for mod in (tloader, jloader):
        with pytest.raises(ValueError, match=what) as e:
            mod.load_csv(path, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_non_numeric_csv_field_names_the_line(tmp_path):
    """The one message that differs from JAX's on purpose: the port puts
    the line before NumPy's message, which the JAX fallback raises bare."""
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as fh:
        fh.write("1,0.5,0.25\n-1,0.1,abc\n")
    with pytest.raises(ValueError) as ej:
        jloader.load_csv(path)
    with pytest.raises(ValueError) as et:
        tloader.load_csv(path)
    assert str(et.value) == f"{path}:2: {ej.value}"


@pytest.mark.parametrize("allow", [False, True])
def test_allow_nonfinite_matches_jax(tmp_path, allow, capsys):
    path = str(tmp_path / "nan.csv")
    with open(path, "w") as fh:
        fh.write("1,0.5,0.25\n-1,0.1,nan\n")
    if not allow:
        with pytest.raises(ValueError, match="--allow-nonfinite"):
            tloader.load_dataset(path)
        return
    xt, _ = tloader.load_dataset(path, allow_nonfinite=True)
    wt = capsys.readouterr().err
    xj, _ = jloader.load_dataset(path, allow_nonfinite=True)
    wj = capsys.readouterr().err
    np.testing.assert_array_equal(xt, xj)
    assert wt == wj and "loading anyway" in wt


def _models(seed=0):
    """(port model, JAX model) pairs over the layouts: reference RBF,
    zero alphas skipped, a kernel header, a task line, svidx rows."""
    x, y = make_blobs(n=60, d=7, seed=seed)
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 3, 60).astype(np.float32)
    alpha[::5] = 0.0
    y = y.astype(np.int32)
    cases = {
        "rbf": dict(kernel="rbf", task="svc"),
        "poly": dict(kernel="poly", coef0=0.5, degree=2, task="svc"),
        "svr": dict(kernel="rbf", task="svr"),
        "oneclass-linear": dict(kernel="linear", task="oneclass"),
    }
    out = {}
    for name, kw in cases.items():
        t = model_from_numpy(x, alpha, y, -0.123456789, 0.0625, **kw)
        j = JModel(x_sv=x, alpha=alpha, y_sv=y, b=-0.123456789,
                   gamma=0.0625, **kw)
        out[name] = (t, j)
    idx = np.arange(0, 120, 2, dtype=np.int64)
    kw = dict(kernel="precomputed", sv_idx=idx, n_train=120)
    out["precomputed"] = (
        model_from_numpy(x[:, :0], alpha + 0.5, y, 0.5, 1.0, **kw),
        JModel(x_sv=x[:, :0], alpha=alpha + 0.5, y_sv=y, b=0.5, gamma=1.0,
               **kw))
    return out


MODELS = sorted(_models())


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("path", ["native", "python"])
def test_model_files_are_byte_for_byte_jax(tmp_path, name, path,
                                           monkeypatch):
    """The port's writer against the JAX package's, which writes the
    reference RBF layout through its C++ ``dpsvm_write_model`` (``path``
    native) or, with ``DPSVM_NO_NATIVE`` set, through its Python fallback;
    the port writes and reads in Python either way."""
    t, j = _models()[name]
    pj, pt = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    if path == "python":
        monkeypatch.setenv("DPSVM_NO_NATIVE", "1")
    wj = jio.save_model(j, pj)
    wt = tio.save_model(t, pt)
    assert wt == wj
    assert Path(pt).read_bytes() == Path(pj).read_bytes()
    back = tio.load_model(pt)
    ref = jio.load_model(pj)
    for a, b in ((back.x_sv, ref.x_sv), (back.alpha, ref.alpha),
                 (back.y_sv, ref.y_sv)):
        np.testing.assert_array_equal(a, b)
    assert (back.b, back.gamma, back.kernel, back.task) == (
        ref.b, ref.gamma, ref.kernel, ref.task)


def test_model_reader_refuses_what_jax_refuses(tmp_path):
    path = str(tmp_path / "bad.model")
    with open(path, "w") as fh:
        fh.write("0.5\n0.1\n1.0,1,0.5,0.25\n2.0,-1,0.5\n")
    msgs = []
    for mod in (tio, jio):
        with pytest.raises(ValueError) as e:
            mod.load_model(path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "fields" in msgs[0]


def test_convert_outputs_are_byte_for_byte_jax(files, tmp_path):
    for kw in (dict(), dict(num_attributes=30)):
        a, b = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
        nj = jconvert.libsvm_to_dense_csv(files["libsvm"], a, **kw)
        nt = tconvert.libsvm_to_dense_csv(files["libsvm"], b, **kw)
        assert nj == nt and Path(a).read_bytes() == Path(b).read_bytes()
    digits = str(tmp_path / "digits.csv")
    rng = np.random.default_rng(1)
    with open(digits, "w") as fh:
        fh.write("label,p1,p2,p3\n")
        for _ in range(40):
            fh.write(f"{rng.integers(10)},"
                     + ",".join(str(v) for v in rng.integers(0, 256, 3))
                     + "\n")
    for kw in (dict(has_header=True), dict(has_header=True, scale=16.0)):
        a, b = str(tmp_path / "jm.csv"), str(tmp_path / "tm.csv")
        nj = jconvert.mnist_to_odd_even_csv(digits, a, **kw)
        nt = tconvert.mnist_to_odd_even_csv(digits, b, **kw)
        assert nj == nt and Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("src", ["csv", "libsvm"])
def test_scale_and_range_files_are_byte_for_byte_jax(files, tmp_path, src):
    out = {}
    for tag, mod in (("j", jscale), ("t", tscale)):
        dst, rng = str(tmp_path / f"{tag}.csv"), str(tmp_path / f"{tag}.r")
        shape = mod.scale_file(files[src], dst, lower=0.0, upper=1.0,
                               save_params=rng)
        dst2 = str(tmp_path / f"{tag}2.csv")
        mod.scale_file(files[src], dst2, restore_params=rng)
        out[tag] = (shape, *(Path(p).read_bytes() for p in (dst, rng,
                                                              dst2)))
    assert out["t"] == out["j"]


def test_range_file_refusals_match_jax(tmp_path):
    path = str(tmp_path / "gap.range")
    with open(path, "w") as fh:
        fh.write("x\n-1 1\n1 0 2\n3 -1 1\n")
    msgs = []
    for mod in (tscale, jscale):
        with pytest.raises(ValueError) as e:
            mod.ScaleParams.load(path)
        msgs.append(str(e.value))
        p = mod.ScaleParams.load(path, num_features=4)
        np.testing.assert_array_equal(p.fmin, [0, 0, -1, 0])
    assert msgs[0] == msgs[1]


def test_the_library_is_the_ports_own_build():
    lib = native.load_native_lib()
    assert lib is not None
    path = Path(lib._name)
    assert path.parent == ROOT / "dpsvm_tpu_torch" / "_build"
    assert re.fullmatch(r"libdpsvm_native-[0-9a-f]{16}\.so", path.name)
    assert path == nbuild.library_path()
    # a copy of the JAX source: the same C ABI, declaration for declaration
    sig = re.compile(r"^(?:int|long) (dpsvm_\w+)\(([^)]*)\)", re.M)
    mine = (ROOT / "dpsvm_tpu_torch/native/csv_loader.cpp").read_text()
    theirs = (ROOT / "dpsvm_tpu/native/csv_loader.cpp").read_text()
    norm = lambda s: [(n, " ".join(a.split())) for n, a in sig.findall(s)]
    assert norm(mine) == norm(theirs) and len(norm(mine)) == 7


def test_build_native_raises_without_a_compiler(no_compiler):
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        nbuild.build_native()


def test_no_native_env_takes_python(files, monkeypatch):
    monkeypatch.setenv("DPSVM_NO_NATIVE", "1")
    x, _ = tloader.load_csv(files["csv"])
    assert native.last_path() == "python"
    np.testing.assert_array_equal(x, jloader.load_csv(files["csv"])[0])
