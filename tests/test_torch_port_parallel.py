"""The port's data- and tensor-parallel paths (tpudf_torch/core/mesh.py,
parallel/{dist,hostdata,sharding,inference,training}.py) on a gloo world
of 4 CPU ranks, held to the single-process port and to the JAX package.

A module fixture starts the world (torchrun over tests/_torch_mp_worker.py,
which imports only torch and the port) on seeded inputs and reads each
rank's results; the references run here meanwhile. Tolerances:
  HostShardedSampler  equal to JAX's for each (n, global batch, P), gb > n
       among them; ranks of one model group get the same rows
  DP features (test-32, F32, B 10: 2 rows padded)  atol 1e-6 of the
       single-process port (each rank runs the same rows' arithmetic)
  DP full analysis (test-32 static W8A8 from JAX's quantize, B 6: 2 rows
       padded)  atol 1e-6 of the port's predict_batch; against JAX's
       sharded_detect_core on its mesh8 (4 x 2) the calibrated outputs
       within JAX's 5e-4, z_sig within the W8A8 engine rule of
       tests/test_torch_port_engine.py (5e-2: int8 rounding ties)
  TP forward  JAX's tolerances against the replicated forward: test-32
       2e-3, large-384's width with 4 layers at 96 px 3e-3
  TP gradient (every rank the whole batch)  each rank's gradient equals
       its part of the single-process gradient within atol 2e-5 + rtol
       1e-4 (f32 sums in another order)
  ShardedTrainer (2, 2), the tower trained, dropout and mixup on, 3
       steps  against the single-process replay of the same global
       batches and generators: JAX's 1e-4 on the loss, 2e-4 on the
       head's fc1 and on every backbone leaf
  the MTL step over the data axis of 4 (masks on 2 of 8 rows)  loss
       within 1e-4, cls_acc exact
"""

import copy
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_mp_worker as W
from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.calib.coral import CoralCutpoints as JCuts
from tpudf.core.mesh import make_mesh as j_make_mesh
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.data.pipeline import normalize_siglip as j_normalize
from tpudf.models.freq_mlp import init_freq_mlp as j_init_freq
from tpudf.models.fusion import init_fusion_linear as j_init_fusion
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.ops.quant import calibrate_siglip_act_scales as j_calibrate
from tpudf.ops.quant import quantize_siglip_static as j_quantize
from tpudf.parallel.hostdata import HostShardedSampler as JSampler
from tpudf.parallel.inference import sharded_detect_core as j_sharded_core
from tpudf.serve.engine import DetectEngine as JEngine
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.models.siglip import CONFIGS, init_siglip, siglip_forward
from tpudf_torch.parallel.dist import torchrun
from tpudf_torch.parallel.hostdata import HostShardedSampler
from tpudf_torch.parallel.sharding import split_siglip_tree
from tpudf_torch.parallel.training import batch_generator
from tpudf_torch.serve.engine import DetectEngine
from tpudf_torch.train.steps import init_train_state, tensor_leaves

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CONFIGS["test-32"]
JCFG = J_CONFIGS["test-32"]
DETECT_KEYS = ("p_blend", "visual_prob", "max_patch", "patch_mean",
               "embed_l2")


def _jax_engine():
    """JAX's test-32 W8A8 engine (F32), quantised as `quantize()` does."""
    k = jax.random.key(0)
    tree = numpy_params(lambda: {
        "backbone": j_init_siglip(k, JCFG), "head": j_init_head(k, 64),
        "freq": j_init_freq(k), "fusion": j_init_fusion(k)}, 3)
    calib = j_normalize(jnp.asarray(
        np.random.default_rng(0).random((16, 32, 32, 3)), jnp.float32))
    tree["backbone"] = jax.jit(lambda bb, px: j_quantize(
        bb, j_calibrate(bb, JCFG, px, J_F32), JCFG))(tree["backbone"], calib)
    jeng = JEngine(cfg=JCFG, cuts=JCuts.default(), policy=J_F32, **tree)
    port = params_from_numpy({**jax.tree.map(np.asarray, tree),
                              "cuts": jeng.cuts}, "cpu")
    return jeng, port


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the gloo world of 4; yields (inputs, JAX engine, results)
    where results() waits for the ranks and loads their files."""
    root = tmp_path_factory.mktemp("world")
    tower_np = numpy_params(lambda: j_init_siglip(jax.random.key(0), JCFG),
                            1)
    jeng, eng = _jax_engine()
    rng = np.random.default_rng(0)
    inp = {"tower": params_from_numpy(tower_np, "cpu"), "engine": eng,
           "px_features": rng.random((10, 32, 32, 3)).astype(np.float32),
           "px_detect": rng.integers(0, 256, (6, 32, 32, 3), np.uint8),
           "px_tp": rng.random((8, 32, 32, 3)).astype(np.float32),
           "grad_probe": rng.standard_normal((8, 64)).astype(np.float32)}
    torch.save(inp, str(root / "inputs.pt"))
    proc = torchrun(4, [os.path.join(_repo, "tests", "_torch_mp_worker.py"),
                        "--inputs", root / "inputs.pt", "--out", root],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
    done = {}

    def results():
        if not done:
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, out[-4000:]
            done["ranks"] = [torch.load(str(root / f"rank{r}.pt"),
                                        weights_only=False)
                             for r in range(4)]
        return done["ranks"]

    yield inp, jeng, results
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _pooled(params, px, cfg=CFG):
    with torch.no_grad():
        return siglip_forward(params, torch.from_numpy(px), cfg,
                              F32_POLICY)["pooled"].numpy()


def test_split_is_by_heads_inside_q_k_v():
    """Rank i holds heads [i·H/m, (i+1)·H/m) of q, of k and of v; a
    contiguous split of the fused 3W axis would not."""
    w, h, d = CFG.width, CFG.heads, CFG.head_dim
    tree = init_siglip(torch.Generator().manual_seed(0), CFG)
    code = torch.arange(3 * w, dtype=torch.float32)    # column ids
    tree["blocks"]["attn"]["qkv_w"][:] = code
    tree["head"]["in_w"][:] = code
    for i in range(2):
        part = split_siglip_tree(tree, CFG, 2, i)
        want = torch.cat([torch.arange(c * w + i * (h // 2) * d,
                                       c * w + (i + 1) * (h // 2) * d)
                          for c in range(3)]).float()
        for got in (part["blocks"]["attn"]["qkv_w"][0, 0],
                    part["head"]["in_w"][0]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert not torch.equal(got, code.chunk(2)[i])
        assert part["blocks"]["mlp"]["fc1_w"].shape[-1] == CFG.mlp_dim // 2
        assert part["blocks"]["attn"]["out_w"].shape[-2] == w // 2


@pytest.mark.parametrize("n,gb,procs", [(37, 8, 4), (6, 16, 4), (16, 16, 2),
                                        (5, 12, 3)])
def test_sampler_matches_jax(n, gb, procs):
    for p in range(procs):
        got = HostShardedSampler(n, gb, seed=3, process_index=p,
                                 process_count=procs)
        want = JSampler(n, gb, seed=3, process_index=p, process_count=procs)
        for epoch in (0, 1):
            np.testing.assert_array_equal(got.epoch_order(epoch),
                                          want.epoch_order(epoch))
            for a, b in zip(got.local_batches(epoch),
                            want.local_batches(epoch), strict=True):
                np.testing.assert_array_equal(a, b)


def test_dp_full_analysis_matches_port_and_jax(world):
    """First of the world's tests: JAX compiles its sharded core while
    the ranks run."""
    inp, jeng, results = world
    px = inp["px_detect"]
    ref = DetectEngine(cfg=CFG, policy=F32_POLICY,
                       **inp["engine"]).predict_batch(px)
    mesh8 = j_make_mesh(jax.devices()[:8], data=4, model=2)
    jout = j_sharded_core(mesh8, jeng)(px.astype(np.float32))
    for r in results():
        got = r["dp_detect"]
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        for k in DETECT_KEYS:
            np.testing.assert_allclose(got[k], np.asarray(jout[k]), rtol=0,
                                       atol=5e-4, err_msg=k)
        np.testing.assert_allclose(got["z_sig"], np.asarray(jout["z_sig"]),
                                   rtol=0, atol=5e-2)


def test_world_sampler_rows_follow_the_data_axis(world):
    ranks = world[2]()
    for n, gb, seed in W.SAMPLER_CASES:
        for r in ranks:
            want = JSampler(n, gb, seed=seed, process_index=r["data_index"],
                            process_count=2)
            np.testing.assert_array_equal(
                r[f"sampler_{n}_{gb}"], np.stack(list(want.local_batches(0))))
        # the two ranks of each model group read the same rows
        np.testing.assert_array_equal(ranks[0][f"sampler_{n}_{gb}"],
                                      ranks[1][f"sampler_{n}_{gb}"])


def test_dp_features_match_single_process(world):
    inp, _, results = world
    ref = _pooled(inp["tower"], inp["px_features"])
    for r in results():
        assert r["dp_features"].shape == ref.shape
        np.testing.assert_allclose(r["dp_features"], ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["test-32", "large-384x4"])
def test_tp_forward_matches_replicated(world, which):
    inp, _, results = world
    if which == "test-32":
        ref, key, tol = _pooled(inp["tower"], inp["px_tp"]), "tp_features", \
            2e-3
    else:
        cfg = W.large_cfg()
        big = init_siglip(torch.Generator().manual_seed(9), cfg)
        px = np.random.default_rng(9).random(
            (W.LARGE_B, W.LARGE_PX, W.LARGE_PX, 3)).astype(np.float32)
        ref, key, tol = _pooled(big, px, cfg), "tp_large", 3e-3
        del big
    for r in results():
        np.testing.assert_allclose(r[key], ref, atol=tol, rtol=tol)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad


def test_tp_gradient_matches_single_process(world):
    inp, _, results = world
    tree = copy.deepcopy(inp["tower"])
    for t in tensor_leaves(tree):
        t.requires_grad_(True)
    pooled = siglip_forward(tree, torch.from_numpy(inp["px_tp"]), CFG,
                            F32_POLICY)["pooled"]
    (pooled * torch.from_numpy(inp["grad_probe"])).sum().backward()
    grads = _grads(tree)
    for r in results():
        want = split_siglip_tree(grads, CFG, 2, r["model_index"])
        got = r["tp_grads"]
        assert len(tensor_leaves(got)) == len(tensor_leaves(want))
        for a, b in zip(tensor_leaves(got), tensor_leaves(want)):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4)


def test_sharded_trainer_matches_single_process_replay(world):
    _, _, results = world
    params, opt, step = W.trainer_parts(CFG, F32_POLICY)
    state = init_train_state(params, opt)
    pixels, labels = W.train_data(CFG.image_size)
    order = HostShardedSampler(W.TRAIN_N, W.TRAIN_GB, seed=1).epoch_order(0)
    for bi in range(len(order) // W.TRAIN_GB):
        idx = order[bi * W.TRAIN_GB:(bi + 1) * W.TRAIN_GB]
        state, m = step(state, None, {"pixels": torch.from_numpy(pixels[idx]),
                                      "labels": torch.from_numpy(labels[idx])},
                        batch_generator(W.TRAIN_SEED, bi, "cpu"))
    assert bi == 2                                     # 3 steps
    for r in results():
        np.testing.assert_allclose(r["train_metrics"]["loss"],
                                   float(m["loss"]), atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(r["train_head"]["w"],
                                   state.params["head"]["fc1"]["w"].detach(),
                                   atol=2e-4, rtol=2e-4)
        for a, b in zip(tensor_leaves(r["train_backbone"]),
                        tensor_leaves(state.params["backbone"]),
                        strict=True):
            torch.testing.assert_close(a, b.detach(), atol=2e-4, rtol=2e-4)


def test_optimizer_updates_one_process_after_the_trainer(world):
    """The trainer's gradient sync lives on its optimizer for the length
    of a step only: after the run, an update on each rank's own gradients
    is the single-process update, not one averaged over the data group."""
    for r, got in enumerate(world[2]()):
        assert got["after_trainer_sync"]
        _, opt, _ = W.trainer_parts(CFG, F32_POLICY)
        p = [torch.zeros(3)]
        _, norm = opt.update(W.after_trainer_grads(r), opt.init(p), p)
        param, got_norm = got["after_trainer_update"]
        torch.testing.assert_close(param, p[0], rtol=0, atol=0)
        assert got_norm == float(norm)


def test_mtl_step_sharded_over_the_data_axis(world):
    _, _, results = world
    params, opt, init_fn, step = W.mtl_parts(CFG, F32_POLICY)
    state = init_fn(params)
    batch = {k: torch.from_numpy(v) for k, v in W.mtl_batch(
        CFG.image_size).items()}
    _, m = step(state, batch, torch.Generator().manual_seed(5), 1.0, 0.5)
    for r in results():
        got = r["mtl_metrics"]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(got["seg_loss"], float(m["seg_loss"]),
                                   atol=1e-4, rtol=1e-4)
        assert got["cls_acc"] == float(m["cls_acc"])
