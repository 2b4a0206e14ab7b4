"""Pretrain + cache the face nets, the 5-point landmarks and the identity
embedding (tpudf/cli/face_pretrain.py).

The environment-native replacement for downloading insightface weights
(appv3.py:67-90): trains models/face_landmark.py and models/face_embed.py
on the procedural generator (data/synth_faces.py), or the identity net on
real identities (--identity_dir), and writes the weights where
serve/face.get_landmark_params / get_face_embed_params find them, in the
JAX package's npz format. Deterministic for a seed on a device.

Usage:
  python -m tpudf_torch.cli.face_pretrain [--device cuda] [--steps 3000]
      [--embed_steps 2000] [--out PATH] [--embed_out PATH]
      [--skip_landmarks] [--skip_embed] [--identity_dir DIR]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="pretrain face nets")
    p.add_argument("--steps", type=int, default=3000,
                   help="landmark-net pretraining steps")
    p.add_argument("--embed_steps", type=int, default=2000,
                   help="identity-embedding contrastive steps")
    p.add_argument("--embed_ids", type=int, default=256,
                   help="identity pool size for the contrastive net")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="landmark .npz (default: the serve-time cache path)")
    p.add_argument("--embed_out", default=None,
                   help="identity-embed .npz (default: serve-time cache)")
    p.add_argument("--skip_landmarks", action="store_true")
    p.add_argument("--skip_embed", action="store_true")
    p.add_argument("--identity_dir", default=None,
                   help="train the identity embedding on REAL identities "
                        "(one subdirectory of aligned face crops per "
                        "identity) instead of the procedural generator — "
                        "the docs/CERTIFICATION.md §2 upgrade path")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    args = p.parse_args(argv)

    from tpudf_torch.serve.face import _DEFAULT_CACHE, _EMBED_CACHE

    if not args.skip_landmarks:
        from tpudf_torch.models.face_landmark import (save_landmark_net,
                                                      train_landmark_net)
        params = train_landmark_net(steps=args.steps, batch=args.batch,
                                    size=args.size, seed=args.seed,
                                    log_every=max(1, args.steps // 10),
                                    device=args.device)
        out = args.out or os.path.expanduser(_DEFAULT_CACHE)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_landmark_net(params, out)
        print(f"[face_pretrain] landmarks saved → {out}")

    if not args.skip_embed:
        from tpudf_torch.models.face_embed import (load_crop_pool_from_dir,
                                                   save_face_embed,
                                                   train_face_embed)
        pool = None
        if args.identity_dir:
            pool = load_crop_pool_from_dir(args.identity_dir)
            print(f"[face_pretrain] real-identity pool: "
                  f"{pool.shape[0]} ids x {pool.shape[1]} views")
        params = train_face_embed(steps=args.embed_steps,
                                  n_ids=args.embed_ids, seed=args.seed,
                                  pool=pool,
                                  log_every=max(1, args.embed_steps // 10),
                                  device=args.device)
        out = args.embed_out or os.path.expanduser(_EMBED_CACHE)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        save_face_embed(params, out)
        print(f"[face_pretrain] identity embed saved → {out}")


if __name__ == "__main__":
    main()
