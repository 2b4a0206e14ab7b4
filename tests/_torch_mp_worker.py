"""Worker of tests/test_torch_port_parallel.py: one rank of a gloo world
on the CPU, launched by torchrun:

    python -m torch.distributed.run --nproc_per_node 4 \\
        tests/_torch_mp_worker.py --inputs IN.pt --out DIR

It imports torch and tpudf_torch only. Every rank builds the same meshes
over the world of 4 ((4, 1) and (2, 2)), runs the port's data- and
tensor-parallel paths on its own rows and heads, and saves what it got to
DIR/rank{r}.pt; the test holds that against the single-process port and
the JAX package. `--mode ok` only initialises and all-reduces (exit 0);
`--mode kill` has rank 1 SIGKILL itself (the run must fail).
"""

import argparse
import dataclasses
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpudf_torch.parallel.dist import initialize_from_env, world  # noqa: E402

# the sampler's (n, global batch) cases, global batch > n among them
SAMPLER_CASES = ((37, 8, 3), (6, 16, 0), (16, 16, 5))
TRAIN_N, TRAIN_GB, TRAIN_SEED = 24, 8, 9
LARGE_LAYERS, LARGE_PX, LARGE_B = 4, 96, 4


def large_cfg():
    from tpudf_torch.models.siglip import CONFIGS
    return dataclasses.replace(CONFIGS["large-384"], layers=LARGE_LAYERS)


def trainer_parts(cfg, policy):
    """(params, optimizer, step) of the binary trainer with the tower
    trained, from seeds: the run and its single-process replay build the
    same."""
    from tpudf_torch.models.heads import init_binary_head
    from tpudf_torch.models.siglip import init_siglip
    from tpudf_torch.train.steps import make_binary_train_step, make_optimizer
    bb = init_siglip(torch.Generator().manual_seed(3), cfg)
    head = init_binary_head(torch.Generator().manual_seed(4), cfg.width)
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=8,
                         grad_clip=1.0)
    step = make_binary_train_step(cfg, opt, policy, train_backbone=True,
                                  mixup_alpha=0.2)
    return {"backbone": bb, "head": head}, opt, step


def after_trainer_grads(rank):
    """Gradients whose mean over a data group differs from each rank's
    own, in sign and in norm."""
    return [torch.tensor([1.0, -2.0, 3.0]) * (1.0 if rank < 2 else -2.0)]


def train_data(size):
    rng = np.random.default_rng(0)
    pixels = rng.random((TRAIN_N, size, size, 3)).astype(np.float32)
    labels = (np.arange(TRAIN_N) % 2).astype(np.float32)
    return pixels, labels


def mtl_parts(cfg, policy):
    from tpudf_torch.models.segformer import MTLConfig, init_mtl
    from tpudf_torch.train.mtl import make_mtl_train_step
    from tpudf_torch.train.steps import make_optimizer
    mcfg = MTLConfig(backbone=cfg, seg_layers=(-1,), embed_dim=16)
    params = init_mtl(torch.Generator().manual_seed(4), mcfg)
    opt = make_optimizer(lr=1e-2, warmup_steps=1, total_steps=4)
    init_fn, step = make_mtl_train_step(mcfg, opt, policy, freeze_below=1,
                                        seg_loss="bce_dice")
    return params, opt, init_fn, step


def mtl_batch(size, b=8):
    rng = np.random.default_rng(4)
    return {"pixels": rng.random((b, size, size, 3)).astype(np.float32),
            "cls": (np.arange(b) % 3).astype(np.int64),
            "mask": (rng.random((b, size, size)) > 0.5).astype(np.float32),
            "has_mask": (np.arange(b) % 3 == 2).astype(np.float32)}


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items() if k != "tp"}
    return tree.grad.clone()


def run_all(args):
    from tpudf_torch.core.mesh import make_mesh
    from tpudf_torch.core.precision import F32_POLICY
    from tpudf_torch.models.siglip import CONFIGS, init_siglip, siglip_forward
    from tpudf_torch.parallel.hostdata import HostShardedSampler
    from tpudf_torch.parallel.inference import (sharded_detect_core,
                                                sharded_siglip_features)
    from tpudf_torch.parallel.sharding import shard_siglip_params
    from tpudf_torch.parallel.training import ShardedTrainer
    from tpudf_torch.serve.engine import DetectEngine
    from tpudf_torch.train.steps import tensor_leaves

    torch.set_num_threads(1)
    rank, n = world()
    assert n == 4, n
    cfg = CONFIGS["test-32"]
    inp = torch.load(args.inputs, weights_only=False)
    mesh_dp = make_mesh(4, 1, device="cpu")
    mesh_tp = make_mesh(2, 2, device="cpu")
    out = {"data_index": mesh_tp.data_index,
           "model_index": mesh_tp.model_index}

    # the sampler: each rank's batches on the (2, 2) mesh
    for n_, gb, seed in SAMPLER_CASES:
        s = HostShardedSampler(n_, gb, seed=seed, mesh=mesh_tp)
        out[f"sampler_{n_}_{gb}"] = np.stack(list(s.local_batches(0)))

    # data parallel: features (10 rows: 2 padded) and the W8A8 full
    # analysis (6 rows: 2 padded)
    run = sharded_siglip_features(mesh_dp, inp["tower"], cfg, F32_POLICY)
    out["dp_features"] = run(batch=inp["px_features"])
    e = inp["engine"]
    eng = DetectEngine(cfg=cfg, policy=F32_POLICY, **e)
    out["dp_detect"] = sharded_detect_core(mesh_dp, eng)(inp["px_detect"])

    # tensor parallel forward at test-32 (B 8 over the data axis of 2) and
    # at large-384's width with 4 layers at 96 px
    run = sharded_siglip_features(mesh_tp, inp["tower"], cfg, F32_POLICY,
                                  tensor_parallel=True)
    out["tp_features"] = run(batch=inp["px_tp"])
    lcfg = large_cfg()
    big = init_siglip(torch.Generator().manual_seed(9), lcfg)
    px = np.random.default_rng(9).random(
        (LARGE_B, LARGE_PX, LARGE_PX, 3)).astype(np.float32)
    out["tp_large"] = sharded_siglip_features(
        mesh_tp, big, lcfg, F32_POLICY, tensor_parallel=True)(batch=px)
    del big

    # the tensor-parallel gradient: every rank the whole batch, its heads
    local = shard_siglip_params(mesh_tp, inp["tower"], True, cfg)
    for t in tensor_leaves(local):
        t.requires_grad_(True)
    pooled = siglip_forward(local, torch.from_numpy(inp["px_tp"]), cfg,
                            F32_POLICY)["pooled"]
    (pooled * torch.from_numpy(inp["grad_probe"])).sum().backward()
    out["tp_grads"] = _grads(local)

    # ShardedTrainer on (2, 2), the tower trained, dropout and mixup on
    params, opt, step = trainer_parts(cfg, F32_POLICY)
    trainer = ShardedTrainer(mesh_tp, step, opt, params, cfg=cfg)
    pixels, labels = train_data(cfg.image_size)
    sampler = HostShardedSampler(TRAIN_N, TRAIN_GB, seed=1, mesh=mesh_tp)
    m = trainer.run_epoch({"pixels": pixels, "labels": labels}, sampler,
                          epoch=0, seed=TRAIN_SEED)
    out["train_metrics"] = {k: float(v) for k, v in m.items()}
    out["train_head"] = {k: v.detach().clone() for k, v in
                         trainer.state.params["head"]["fc1"].items()}
    out["train_backbone"] = trainer.backbone_params(cfg)
    # after its steps the trainer's optimizer updates this rank alone
    out["after_trainer_sync"] = opt.grad_sync is None
    g = after_trainer_grads(rank)
    p = [torch.zeros(3)]
    _, norm = opt.update(g, opt.init(p), p)
    out["after_trainer_update"] = (p[0].clone(), float(norm))

    # the MTL step with its batch over the data axis of 4
    params, opt, init_fn, step = mtl_parts(cfg, F32_POLICY)
    trainer = ShardedTrainer(mesh_dp, step, opt, params, init_fn=init_fn)
    batch = mtl_batch(cfg.image_size)
    rows = slice(mesh_dp.data_index * 2, mesh_dp.data_index * 2 + 2)
    m = trainer.step({k: v[rows] for k, v in batch.items()},
                     torch.Generator().manual_seed(5), 1.0, 0.5)
    out["mtl_metrics"] = {k: float(v) for k, v in m.items()}

    torch.save(out, os.path.join(args.out, f"rank{rank}.pt"))
    dist.barrier()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="all", choices=("all", "ok", "kill"))
    p.add_argument("--inputs")
    p.add_argument("--out")
    args = p.parse_args(argv)
    initialize_from_env(device="cpu")
    rank, _ = world()
    if args.mode == "kill" and rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    if args.mode in ("ok", "kill"):
        t = torch.ones(1)
        dist.all_reduce(t)
        print(f"[rank {rank}] all_reduce {float(t)}", flush=True)
    else:
        run_all(args)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
