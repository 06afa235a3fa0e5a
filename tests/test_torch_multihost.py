"""Process groups of the port (``parallel/multihost.py``), its CLI's
``--shards`` and host flags, shard-aware checkpoints and distributed
shrinking, on the CPU with gloo ranks.

* the uninitialized identity, as ``tests/test_multihost.py`` pins it for
  the JAX package (one host, rank 0, a (1, ...) gather);
* the host-flag errors of ``train``, message for message against the JAX
  CLI;
* two processes joining through ``initialize(coordinator, 2, rank)`` and
  one all-reduce between them;
* ``train --shards 2 --device cpu`` end to end, its model file against the
  single-device CLI's within the repo's LibSVM bar (n_sv within 2% or 3,
  training accuracy within one example);
* a checkpoint saved by 2 ranks resumes on 1 and on 4 ranks, with the
  ``RESHARD:`` line, to the model of an uninterrupted run on that many
  ranks (the same n_iter, alpha within rtol 1e-4 / atol 1e-5: the ranks'
  trajectories differ from one another only by the order of float32
  sums), and loads in the JAX package's ``load_checkpoint`` with
  ``shards == 2``;
* shrinking over 2 ranks follows the same trajectory with the power-of-two
  capacities as with exact-size active sets (the JAX package's
  ``test_dist_bucketed_trajectory_equals_exact``: n_iter equal, |db| <
  1e-6, alpha within 1e-5).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_dist_scenarios import launch

from dpsvm_tpu.data.synthetic import make_blobs, save_csv
from dpsvm_tpu_torch.parallel import multihost
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CKPT = dict(c=10.0, epsilon=1e-3, max_iter=20_000, chunk_iters=32)
DATA = make_blobs(n=200, d=8, seed=4)
SHRINK = make_blobs(n=720, d=16, seed=13)
SHRINK_CFG = {
    "pair": dict(c=10.0, epsilon=1e-3, max_iter=200_000, shrinking=True,
                 chunk_iters=32),
    "decomp": dict(c=10.0, epsilon=1e-3, max_iter=200_000, shrinking=True,
                   working_set=64, chunk_iters=256),
}

_RESULTS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    state = str(tmp_path_factory.mktemp("ckpt") / "state.npz")

    def scenarios(world):
        x, y = DATA
        out = [dict(name="full", x=x, y=y, cfg=CKPT)]
        if world == 2:
            out.append(dict(name="save", x=x, y=y, cfg=dict(
                CKPT, max_iter=96, checkpoint_path=state,
                checkpoint_every=64)))
            for path, cfg in SHRINK_CFG.items():
                for exact in (False, True):
                    out.append(dict(name=f"shrink-{path}-{exact}",
                                    what="shrink", x=SHRINK[0],
                                    y=SHRINK[1], cfg=cfg, exact=exact))
        else:
            out.append(dict(name="resume", x=x, y=y,
                            cfg=dict(CKPT, resume_from=state)))
        return out

    def get(world):
        if world not in _RESULTS:
            if world != 2:
                get(2)              # the checkpoint to resume comes first
            _RESULTS[world] = launch(world, scenarios(world))
        return _RESULTS[world], state
    return get


def test_uninitialized_identity():
    assert not multihost.is_initialized()
    assert multihost.host_count() == 1 and multihost.host_id() == 0
    got = multihost.host_allgather(np.arange(3))
    assert got.shape == (1, 3) and np.array_equal(got[0], np.arange(3))
    assert "0/1" in multihost.process_info()
    assert multihost.coordinator_reachable("nonsense").startswith(
        "malformed")
    env = multihost.local_host_env(3, base={}, device="cuda")
    assert (env["LOCAL_RANK"], env["DPSVM_DEVICE"]) == ("3", "cuda:3")
    assert multihost.local_host_env(1, base={}, device="cpu")[
        "DPSVM_DEVICE"] == "cpu"


@pytest.mark.parametrize("flags", [
    ["--num-hosts", "2"],
    ["--host-id", "1"],
    ["--coordinator", "127.0.0.1:1", "--num-hosts", "2"],
    ["--coordinator", "127.0.0.1:1", "--num-hosts", "2", "--host-id", "5"],
])
def test_host_flag_errors_are_the_jax_clis(flags, tmp_path, capsys):
    from dpsvm_tpu import cli as jcli
    from dpsvm_tpu_torch import cli as tcli
    argv = ["train", "-f", str(tmp_path / "none.csv"), "-m",
            str(tmp_path / "m.svm")] + flags
    msgs = []
    for main in (jcli.main, tcli.main):
        assert main(argv) == 2
        msgs.append(capsys.readouterr().err.strip())
    assert msgs[0] == msgs[1] and msgs[1].startswith("error: --")


WORKER = r"""
import sys
import torch
import torch.distributed as dist
from dpsvm_tpu_torch.parallel import multihost
rank = int(sys.argv[2])
multihost.initialize(sys.argv[1], 2, rank, device="cpu", timeout_s=60)
assert multihost.is_initialized() and multihost.host_count() == 2
assert multihost.host_id() == rank
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
g = multihost.host_allgather(rank * 10)
print("SUM", float(t[0]), g.tolist(), multihost.process_info())
dist.destroy_process_group()
"""


def test_two_processes_initialize_and_all_reduce():
    coord = f"127.0.0.1:{multihost.find_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coord, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert "SUM 3.0 [0, 10]" in out and f"process {r}/2" in out


def test_cli_shards_matches_the_single_device_cli(tmp_path):
    from dpsvm_tpu.models.io import load_model
    x, y = DATA
    data = tmp_path / "train.csv"
    save_csv(str(data), x, y)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    outs = {}
    for tag, extra in (("one", []), ("two", ["--shards", "2"])):
        model = tmp_path / f"{tag}.svm"
        p = subprocess.run(
            [sys.executable, "-m", "dpsvm_tpu_torch", "train", "-f",
             str(data), "-m", str(model), "-c", "10", "--device", "cpu",
             *extra], capture_output=True, text=True, env=env, timeout=180)
        assert p.returncode == 0, p.stderr
        outs[tag] = (load_model(str(model)), p.stdout)
    (m1, out1), (m2, out2) = outs["one"], outs["two"]
    # rank 0 alone prints the report
    assert out2.count("Number of SVs") == 1
    n1, n2 = len(m1.alpha), len(m2.alpha)
    assert abs(n1 - n2) <= max(3, 0.02 * n1)
    acc = [float(o.split("Training accuracy: ")[1].split()[0])
           for o in (out1, out2)]
    assert abs(acc[0] - acc[1]) <= 1.0 / len(y) + 1e-12
    assert abs(m1.b - m2.b) < 1e-3


def test_two_rank_checkpoint_loads_in_jax(ranks):
    from dpsvm_tpu.utils.checkpoint import load_checkpoint as jload
    res, state = ranks(2)
    assert "exception" not in res["save"], res["save"]
    assert res["save"]["n_iter"] == 96 and not res["save"]["converged"]
    ck = jload(state)
    assert ck.shards == 2 and ck.host_count == 2 and ck.host_id == 0
    # saved at the poll that crossed 64; the run stopped at its cap, 96
    assert ck.n_iter == 64 and ck.verify_shard_crcs() == []
    assert ck.alpha.shape == (len(DATA[1]),) and (ck.alpha > 0).any()


@pytest.mark.parametrize("world", [1, 4])
def test_two_rank_checkpoint_resumes_on_another_mesh(ranks, world):
    res, _ = ranks(world)
    full, resumed = res["full"], res["resume"]
    for r in (full, resumed):
        assert "exception" not in r, r.get("exception")
        assert r["ranks_agree"] and r["converged"]
    assert "RESHARD:" in resumed["stderr"]
    assert "(2,)-mesh" in resumed["stderr"] and f"on {world}" in resumed[
        "stderr"]
    assert resumed["n_iter"] == full["n_iter"]
    np.testing.assert_allclose(resumed["alpha"], full["alpha"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("path", sorted(SHRINK_CFG))
def test_dist_shrinking_bucketed_trajectory_equals_exact(ranks, path):
    res, _ = ranks(2)
    bucketed = res[f"shrink-{path}-False"]
    exact = res[f"shrink-{path}-True"]
    for r in (bucketed, exact):
        assert "exception" not in r, r.get("exception")
        assert r["ranks_agree"] and r["converged"]
    assert bucketed["run"]["compactions"] >= 1
    assert bucketed["run"]["capacities"] != exact["run"]["capacities"]
    assert bucketed["n_iter"] == exact["n_iter"]
    assert abs(bucketed["b"] - exact["b"]) < 1e-6
    np.testing.assert_allclose(bucketed["alpha"], exact["alpha"], atol=1e-5)
