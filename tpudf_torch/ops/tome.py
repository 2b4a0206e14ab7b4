"""Token merging (ToMe, Bolya et al. 2023) between tower blocks.

Port of tpudf/ops/tome.py: the deployed schedule constants, the schedule,
and one bipartite-soft-matching merge with size-weighted averaging. The
merge is plain PyTorch (in JAX it is XLA, not Pallas): the similarity is a
batched product, the merge a scatter-add where JAX used a one-hot matmul.
"""

from __future__ import annotations

import torch

DEPLOYED_TOME_R = 96
DEPLOYED_TOME_FLOOR_DIV = 8      # deployed token floor = n_tokens // 8
CONSERVATIVE_TOME_R = 32
DEPLOYED_PATCH_TOME_R = 128
DEPLOYED_PATCH_FLOOR_DIV = 16


def deployed_floor(n_tokens: int) -> int:
    """Deployed token floor for a tower that starts at n_tokens (base-256:
    256 // 8 = 32)."""
    return max(8, n_tokens // DEPLOYED_TOME_FLOOR_DIV)


def deployed_patch_floor(n_tokens: int) -> int:
    return max(8, n_tokens // DEPLOYED_PATCH_FLOOR_DIV)


def merge_schedule(n_tokens: int, layers: int, r: int,
                   min_tokens: int = 64) -> tuple[int, ...]:
    """Per-gap merge counts after each of the first layers-1 blocks,
    clipped so the token count never drops below min_tokens and stays a
    multiple of 8."""
    rs = []
    t = n_tokens
    for _ in range(max(0, layers - 1)):
        ri = min(r, max(0, t - min_tokens), t // 2)
        ri -= ri % 8
        rs.append(ri)
        t -= ri
    return tuple(rs)


def merge_step(x, sizes, r: int, sumsq=None):
    """(B, S, W), (B, S) → (B, S-r, W), (B, S-r).

    Even positions form set A, odd positions set B; each A token is matched
    to its most cosine-similar B token (bf16 features, f32 products) and the
    r best-matched A tokens are averaged, weighted by size, into their
    partners. Survivors: all B tokens, then the kept A tokens in order.
    sumsq: optional (B, S) Σ x² per row from the preceding MLP kernel."""
    b, s, w = x.shape
    if r <= 0:
        return x, sizes
    sp = s - r
    ha = (s + 1) // 2
    hb = s - ha
    x16 = x.to(torch.bfloat16).float()
    if sumsq is None:
        sumsq = torch.sum(x.float() ** 2, dim=-1)
    inv = torch.rsqrt(sumsq.float() + 1e-12)
    sim = torch.matmul(x16[:, 0::2], x16[:, 1::2].transpose(1, 2))
    sim = sim * inv[:, 0::2, None] * inv[:, None, 1::2]      # (B, ha, hb)
    node_max, _ = torch.max(sim, dim=-1)
    node_idx = torch.argmax(sim, dim=-1)        # first maximum, as JAX

    # lax.top_k order: larger first, lower index first among equals
    order = torch.sort(node_max, dim=-1, descending=True, stable=True)[1]
    merged = torch.zeros((b, ha), dtype=torch.bool, device=x.device)
    merged.scatter_(1, order[:, :r], True)

    kept = ~merged
    rank = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
    row_a = torch.where(merged, node_idx, hb + rank)          # (B, ha)
    assign = torch.empty((b, s), dtype=torch.int64, device=x.device)
    assign[:, 0::2] = row_a
    assign[:, 1::2] = torch.arange(hb, device=x.device)

    sz = sizes.to(x.dtype)
    weighted = (x * sz[..., None]).float()
    num = torch.zeros((b, sp, w), dtype=torch.float32, device=x.device)
    num.scatter_add_(1, assign[..., None].expand(b, s, w), weighted)
    den = torch.zeros((b, sp), dtype=torch.float32, device=x.device)
    den.scatter_add_(1, assign, sz.float())
    return (num / den[..., None]).to(x.dtype), den
