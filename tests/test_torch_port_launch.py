"""The port's launch story on the CPU: torchrun (`python -m
torch.distributed.run`, which ships with torch, in place of the JAX
package's cli/launch.py) starts gloo ranks of tests/_torch_mp_worker.py;
a run whose ranks all finish returns 0 and a run with a rank that SIGKILLs
itself fails (cli/launch.py's max(rcs) reads a signal's negative code as
success). `dryrun_multichip(4, device="cpu")` runs one sharded train step
on a (2, 2) mesh of gloo ranks; with device="cuda" and fewer cards it
raises, with no quiet re-run on the CPU. Without torchrun's variables
`initialize_from_env` is a no-op and the mesh is (1, 1). GlobalRows
draws, for each rank's rows, what one process draws for the global batch
(dropout masks, mixup), exactly.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from tpudf_torch.core.mesh import make_mesh
from tpudf_torch.entry import dryrun_multichip
from tpudf_torch.models.siglip import CONFIGS
from tpudf_torch.parallel import dist as pdist
from tpudf_torch.parallel.sharding import (named_shardings,
                                           siglip_param_spec)
from tpudf_torch.train.losses import mixup_apply, mixup_draws
from tpudf_torch.utils.nn import GlobalRows, rand_rows

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def torchruns():
    """Two 2-rank torchrun runs of the worker, started together: "ok"
    (every rank finishes) and "kill" (rank 1 SIGKILLs itself)."""
    procs = {}
    for mode in ("ok", "kill"):
        procs[mode] = pdist.torchrun(
            2, [os.path.join(_repo, "tests", "_torch_mp_worker.py"),
                "--mode", mode], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_dryrun_multichip_on_gloo_cpu_ranks(torchruns, capfd):
    """Runs while the two torchrun runs of the next test do."""
    dryrun_multichip(4, device="cpu")
    assert "[dryrun_multichip] n=4 mesh=(2, 2) cpu" in capfd.readouterr().out


@pytest.mark.parametrize("mode", ["ok", "kill"])
def test_torchrun_two_ranks(torchruns, mode):
    out, err = torchruns[mode].communicate(timeout=120)
    rc = torchruns[mode].returncode
    if mode == "ok":
        assert rc == 0, out[-2000:] + err[-2000:]
        assert "[rank 0] all_reduce 2.0" in out
        assert "[rank 1] all_reduce 2.0" in out
    else:
        assert rc != 0
        assert "SIGKILL" in err or "Signal 9" in err


def test_dryrun_multichip_without_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        dryrun_multichip(4, device="cuda")


def test_single_process_defaults(monkeypatch):
    for v in pdist.ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert pdist.initialize_from_env() is False
    assert pdist.world() == (0, 1)
    mesh = make_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.data_group) == (1, 1, None)
    with pytest.raises(ValueError):
        make_mesh(data=2, device="cpu")
    t = torch.arange(4.0)
    assert torch.equal(pdist.all_reduce(t, None), t)
    assert torch.equal(pdist.all_gather(t, None), t)
    assert torch.equal(pdist.broadcast(t), t)


def test_mesh_rows_of_a_rank():
    """Rank r sits at (r // model, r % model); its rows of the data axis
    are its data index's block, whole on every rank of its model group."""
    from tpudf_torch.core.mesh import (Mesh, data_sharding, replicated,
                                       shard_batch)
    batch = {"x": np.arange(16).reshape(8, 2), "y": np.arange(8)}
    for rank, rows in ((0, slice(0, 4)), (1, slice(0, 4)), (3, slice(4, 8))):
        mesh = Mesh(2, 2, rank, torch.device("cpu"))
        assert (mesh.data_index, mesh.model_index) == (rank // 2, rank % 2)
        assert data_sharding(mesh, 8) == rows
        got = shard_batch(mesh, batch)
        np.testing.assert_array_equal(got["x"].numpy(), batch["x"][rows])
        np.testing.assert_array_equal(got["y"].numpy(), batch["y"][rows])
    assert torch.equal(replicated(mesh, batch["y"]), torch.arange(8))
    with pytest.raises(ValueError):
        data_sharding(mesh, 7)


def test_param_spec_covers_the_tree():
    from tpudf_torch.models.siglip import init_siglip
    tree = init_siglip(torch.Generator().manual_seed(0), CONFIGS["test-32"])
    rules = named_shardings(None, siglip_param_spec(True), tree)

    def walk(t, r):
        if isinstance(t, dict):
            assert set(t) == set(r)
            for k in t:
                walk(t[k], r[k])
        else:
            assert isinstance(r, str)
    walk(tree, rules)
    flat = siglip_param_spec(False)
    assert flat["blocks"]["attn"]["qkv_w"] == "replicated"


def test_global_rows_draw_the_global_batch():
    """Two ranks' rows of a GlobalRows draw are one process's draw of the
    whole batch: uniform numbers, mixup's (lam, perm) and mixed rows."""
    full_gen = torch.Generator().manual_seed(11)
    want = torch.rand((4, 5), generator=full_gen)
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    y = torch.tensor([0.0, 1.0, 1.0, 0.0])
    lam, perm = mixup_draws(torch.Generator().manual_seed(12), 4, 0.4)
    want_x, want_y = mixup_apply(x, y, lam, perm)
    got, got_x, got_y = [], [], []
    for start in (0, 2):
        rows = GlobalRows(torch.Generator().manual_seed(11), 4, start,
                          lambda t: t)
        got.append(rand_rows((2, 5), rows, "cpu"))
        mrows = GlobalRows(torch.Generator().manual_seed(12), 4, start,
                           lambda t, full=(x, y): full[0] if t.shape[-1:]
                           == (3,) else full[1])
        lam_r, perm_r = mixup_draws(mrows, 2, 0.4)
        assert lam_r == lam and torch.equal(perm_r, perm)
        gx, gy = mixup_apply(x[start:start + 2], y[start:start + 2], lam_r,
                             perm_r, rows=mrows)
        got_x.append(gx)
        got_y.append(gy)
    torch.testing.assert_close(torch.cat(got), want, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(got_x), want_x, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(got_y), want_y, rtol=0, atol=0)
    assert np.isfinite(lam)


def test_trainer_installs_grad_sync_for_its_step_only():
    """A world of one: the optimizer carries the trainer's sync inside a
    step, and its own value again after the step, also after one that
    raised."""
    from tpudf_torch.models.heads import init_binary_head
    from tpudf_torch.parallel.training import ShardedTrainer
    from tpudf_torch.train.steps import make_optimizer
    opt = make_optimizer(lr=1e-3, total_steps=4)
    seen = []

    def step(state, extra, batch, rows):
        seen.append(opt.grad_sync)
        if len(seen) == 2:
            raise RuntimeError("planted")
        return state, {"loss": batch["x"].sum()}

    head = init_binary_head(torch.Generator().manual_seed(0), 8)
    trainer = ShardedTrainer(make_mesh(device="cpu"), step, opt, head)
    assert opt.grad_sync is None
    trainer.step({"x": np.ones((2, 3), np.float32)})
    assert seen[0] == trainer._sync and opt.grad_sync is None
    with pytest.raises(RuntimeError, match="planted"):
        trainer.step({"x": np.ones((2, 3), np.float32)})
    assert opt.grad_sync is None
