"""Fused-QKV attention — kernel K9 — and its plain twin.

    qkv (B, S, 3W) bf16, laid out [q | k | v] with heads contiguous
    → o (B, S, W) bf16

Replaces tpudf/ops/attention.py `_attention_qkv_pallas` (inner `kernel`,
`_one_head` without `int8_attn`; wrapper `attention_qkv`), the float
tower's attention. Same arithmetic: scores q·k in f32 times scale, plus an
optional per-key logit bias (ToMe proportional attention: the JAX function
takes it and routes it to `_reference_qkv`; here the same kernel takes
it), softmax in f32, p rounded to bf16 for AV, AV accumulated in f32, the
output rounded once to bf16.

The CUDA kernel is `csrc/attention_sm90.cu` (Hopper's wgmma products and
TMA loads through an mbarrier ring, `csrc/sm90.cuh`). It takes every
head_dim JAX's lane rule admits at W <= 1280 (`HEAD_DIMS`: 1 to 256 and
the multiples of 128 from 384 to 1280; so400m's heads of 72, padded by
the caller, keep their own scale) and S up to MAX_SEQ (its K and V tiles
stream, so nothing in it grows with S); any other shape on a CUDA tensor
raises. Heads of 32 and fewer run on the 64-wide tiles: the wrapper
zero-pads each head's columns of qkv to 64 (`pad_heads`; zero columns add
exact zeros to q·k and p·v, and the scale stays the true head_dim's) and
slices the output (`unpad_heads`); 9b and K10 do the same. Heads of 256
run natively. One persistent block an SM takes items of 128 query rows
(two warpgroups of 64) of one head against its keys, streamed by TMA in
64-key tiles, in two passes over the keys (row max and sum, then p · v);
at the engine's shapes the card's bound is the bytes of qkv. A key bias
reaches the kernel padded to whole 64-key tiles. The wide heads
(WIDE_HEAD_DIMS, no config has them) run on a kernel of their own: Q
streams beside K in 64-column chunks, the scores summed over the head's
chunks, each item one 128-column slice of o.

`attention_qkv_reference` is the twin, the JAX package's `_reference_qkv`;
it also serves calibration and the twin of K1.

K10 (`attention_qkv_bwd`), the backward of K9 without a logit bias:

    qkv (B, S, 3W) bf16, g (B, S, W) bf16 → dqkv (B, S, 3W) bf16

replaces tpudf/ops/attention.py `_attn_qkv_bwd_kernel` (wrapper
`_attention_qkv_bwd_pallas`, reached through the custom VJP of
`_fused_qkv_with_vjp`). Same arithmetic: P = softmax(scale q k^T) in f32,
dV = bf16(P)^T g, dP = g V^T, D = rowsum(dP * P) with the unrounded P,
dS = P * (dP - D) * scale, dQ = bf16(dS) K, dK = bf16(dS)^T Q, f32 sums,
one bf16 rounding of each output. The CUDA kernels are in
`csrc/attention_sm90.cu`: a pass over query tiles (row statistics, D and
dQ) and a pass over key tiles (dK and dV), FlashAttention-2's split, with
the other side's rows streamed by TMA in 64-row tiles, because one head's
(S, S) f32 P does not fit an SM. It takes HEAD_DIMS (so400m's heads of 72
padded by the caller keep their own scale; at 256 and wider each block
owns one 128-column slice of dq, or of dk and dv, and at the wide heads
its own rows stream in 64-column chunks too) and any S up to
SM90_MAX_SEQ_BWD, ragged ones (a multiple of 8, not of 64) included.
`attention_qkv_bwd_reference` is its twin, the TPU kernel's formulas in
PyTorch. The route is JAX's (`_fused_qkv_with_vjp.bwd`,
`attention_qkv_bwd_fits`): where the (S, S) f32 tile and the qkv rows fit
12 MiB, lanes align, S % 8 == 0 and W % 128 == 0 (and
TPUDF_PALLAS_ATTN_BWD is not "0") a CUDA tensor launches K10 and a CPU
tensor takes its twin; elsewhere (so400m-512's padded heads at S = 1024,
large-384 at 512 px) the gradient is the VJP of the forward's twin
recomputed under autograd (`attention_qkv_bwd_twin_vjp`), the port's
counterpart of JAX's XLA recompute, counted on the card as
KERNEL_BWD_TWIN. A K10 that fails to build or launch raises; it never
gives way to that route.

Kernel 9b (`attention_qkv_int8`), the same attention with dynamically
quantised int8 products, replaces `_attention_qkv_pallas(...,
int8_attn=True)` (`_one_head`), which JAX's static-W8A8 block runs on its
`attn_out_int8` reference route under TPUDF_INT8_ATTN=1: per head, q
quantised with aq = amax|q| + 1e-6 over each query block of min(256, S)
rows (the Pallas grid's block, the q axis zero-padded), k and v with their
amax over all S rows, clipped to ±127; int8 QKᵀ with int32 sums scaled by
(aq·ak)/127² · scale; an exact f32 softmax; p quantised per row with ap =
max p + 1e-20, not clipped; int8 p·v scaled by ap·av/127²; bf16 out. Its
CUDA kernels are `csrc/attention_i8.cu`: a pre-pass (`i8dyn_prepass`)
fills the amax table and, at heads of 64 and 128 (I8_SM90_HEAD_DIMS; 32
and fewer zero-padded to 64), writes every code once (q8, k8 and v8
transposed with its keys in `vt_pos` order, zeros past S); the main pass
(`i8dyn_main`) runs both products on int8 wgmma with the codes arriving by
TMA. Heads of 256 and 384-1280 keep the two-pass tile on int8 mma.sync,
which quantises its own tiles from qkv (at the wide heads the q and k
codes sit in dynamic shared memory and o runs in 128-column slices);
HEAD_DIMS, S up to MAX_SEQ (its int32 sums of p8 · v8 reach 127² S, under
2^31 up to S = 133,144). `attention_qkv_int8_reference` is its twin,
written from `_one_head`; `attention_i8_codes_reference` is the pre-pass's
plain version.

`attention_qkv_vjp` is the tower's attention: one autograd Function whose
forward is K9 and whose backward is K10 (or their twins), saving only qkv
as the JAX VJP does.

Kernels 11 and 12 (`attention`, `attention_bshd`), plain multi-head
attention over separate q, k and v with Sq != Skv allowed:

    q (B, H, Sq, D), k, v (B, H, Skv, D) → o (B, H, Sq, D)     kernel 11
    q (B, Sq, H, D), k, v (B, Skv, H, D) → o (B, Sq, H, D)     kernel 12

replace tpudf/ops/attention.py `_attn_kernel` (wrapper `_attention_pallas`,
behind `attention`; the multi-query branch of the tower's `_mha`) and the
inner `kernel` of `_attention_pallas_bshd` (behind `attention_bshd`). Same
arithmetic: scores in f32 times scale, keys past Skv masked to -inf, an
exact softmax, p cast to v's dtype, f32 sums, the output in q's dtype.
Both layouts are read where they lie, never transposed. bf16 runs on
Hopper's wgmma and TMA (`csrc/attention_plain_sm90.cu`, K9's persistent
block on `csrc/sm90.cuh`, 4-D tensor maps built from the strides; head_dim
64 and 128 on tiles of their width, 72 on an 80-wide one, a 64-column and
a 16-column sub-tile whose last 8 columns the copy engine fills with
zeros), f32 in exact f32 SIMT products tiled in registers
(`csrc/attention_plain.cu`, head_dim <= 128). Other dtypes or head_dims on
a CUDA tensor raise, except where JAX's own predicate sends `attention` to
XLA (Sq > 4096), where the twin runs.
`attention_reference` and `_reference_bshd` are the twins (JAX's); the
backward recomputes the twin and applies its VJP (`twin_vjp`), as JAX's
`_fused_with_vjp` and `_fused_bshd_with_vjp` recompute through XLA.
"""

from __future__ import annotations

import os

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.twin_vjp import with_twin_vjp

KERNEL = "attention_qkv"
KERNEL_BWD = "attention_qkv_bwd"
KERNEL_INT8 = "attention_qkv_int8"
# K1, K6, K9, 9b and K10: the head_dims JAX's lane rule (head_dim % 128
# == 0 or 128 % head_dim == 0) admits at W <= 1280
WIDE_HEAD_DIMS = tuple(range(384, 1281, 128))   # their own kernels
HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64, 128, 256) + WIDE_HEAD_DIMS
# K1, K6, K9, 9b and K10 run these on zero-padded 64-wide heads (K6's
# panel holds 16 and 32 as they are and pads the narrower ones to 16)
PADDED_HEAD_DIMS = (1, 2, 4, 8, 16, 32)
PAD_HEAD_DIM = 64
# K1, K6, K9 and 9b: the longest sequence (csrc/common.cuh kMaxSeq; 9b's
# int32 p8 · v8 sums bound it) and the most rows B·S of a call (the
# kernels index rows b·S + r as ints)
MAX_SEQ = 1 << 17
MAX_ROWS = 2 ** 31 - 1
KERNEL_BWD_TWIN = "attention_qkv_bwd_twin_vjp"  # JAX's XLA-recompute route
BWD_HEAD_DIMS = HEAD_DIMS   # K10
BWD_FIT_BYTES = 12 * 1024 * 1024   # JAX's VMEM fit for the Pallas backward
INT8_Q_BLOCK = 256          # JAX's q_block: 9b's aq is taken per block
I8_SM90_HEAD_DIMS = (64, 128)   # 9b's wgmma pass (csrc/attention_i8.cu)
I8_ROWS = 128               # its query rows an item: S_pad's multiple
KERNEL_PLAIN = "attention"  # kernel 11, (B, H, S, D)
KERNEL_BSHD = "attention_bshd"   # kernel 12, (B, S, H, D)
PLAIN_HEAD_DIMS = (64, 72, 128)  # kernels 11 and 12 in bf16
PLAIN_F32_MAX_HEAD_DIM = 128     # and in f32
PALLAS_MAX_SQ = 4096        # JAX's `attention` sends longer queries to XLA
PLAIN_F32_ROWS = 48         # csrc/attention_plain.cu: query rows a block
# csrc/attention_sm90.cu (K10): the longest sequence, the rows of a
# streamed tile and of a block, and the shared memory a block may have
SM90_MAX_SEQ_BWD = 2048
SM90_TILE_ROWS = 64
SM90_BLOCK_ROWS = 128
SM90_BLOCK_SMEM = 232448


def kernel_head_dim(head_dim):
    """The head_dim K9, 9b and K10's kernels run `head_dim` at: 64 for
    the PADDED_HEAD_DIMS, else itself."""
    return PAD_HEAD_DIM if head_dim in PADDED_HEAD_DIMS else head_dim


def pad_heads(t, heads, head_dim, to):
    """(..., n·heads·head_dim) → (..., n·heads·to): each head's columns of
    each of the n parts ([q | k | v], or one) zero-padded to `to`."""
    lead, n = t.shape[:-1], t.shape[-1] // (heads * head_dim)
    return torch.nn.functional.pad(
        t.reshape(*lead, n, heads, head_dim),
        (0, to - head_dim)).reshape(*lead, n * heads * to)


def unpad_heads(t, heads, head_dim, to):
    """The inverse of `pad_heads`: each head's first head_dim of `to`
    columns."""
    lead, n = t.shape[:-1], t.shape[-1] // (heads * to)
    return t.reshape(*lead, n, heads, to)[..., :head_dim].reshape(
        *lead, n * heads * head_dim)


def check_attention_shape(name, qkv, heads, head_dim):
    """Raise unless `qkv` is bf16 (B, S, 3·heads·head_dim) with head_dim
    in HEAD_DIMS, S <= MAX_SEQ and B·S <= MAX_ROWS (the attention
    kernels' limits)."""
    b, s, w3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or head_dim not in HEAD_DIMS
            or s > MAX_SEQ or b * s > MAX_ROWS
            or w3 != 3 * heads * head_dim):
        raise ValueError(f"{name} takes bf16 qkv with head_dim in "
                         f"{HEAD_DIMS}, S <= {MAX_SEQ} and B·S <= "
                         f"{MAX_ROWS}, got "
                         f"{qkv.dtype} {tuple(qkv.shape)} heads {heads} "
                         f"head_dim {head_dim}")


def sm90_dkv_smem(s, head_dim):
    """Shared bytes of K10's dkv block at sequence s (`DkvSmem`): K and V
    of 128 rows, the ring's stages of a 64-row Q and g chunk (6 at
    head_dim 64, 4 at 128, 1 at 256; heads of 16 and 32 run at 64), the
    barriers, the head's row statistics (4 f32 per row, S rounded up to the
    chunks) and 1 KB for the alignment of the swizzled tiles. At the wide
    heads (`WideDkvSmem`): two stages of 64-column chunks (K and V of 128
    rows, Q and g of 64) with the 128-column Q and g slices, the staging
    tile of dk and dv (128 x 128), the barriers, the statistics, 1 KB."""
    n_stat = -(-s // SM90_TILE_ROWS) * SM90_TILE_ROWS
    if head_dim in WIDE_HEAD_DIMS:
        box = SM90_TILE_ROWS * 128
        return 2 * 10 * box + 4 * box + 128 + 16 * n_stat + 1024
    head_dim = kernel_head_dim(head_dim)
    tile = lambda rows: rows * head_dim * 2
    stages = {64: 6, 128: 4}.get(head_dim, 1)
    return (2 * tile(SM90_BLOCK_ROWS) + stages * 2 * tile(SM90_TILE_ROWS)
            + 128 + 16 * n_stat + 1024)


def sm90_fwd_fits(s, w, head_dim):
    """Whether K9's kernel takes qkv (B, s, 3w): a head_dim it is built
    for, S <= MAX_SEQ, and rows (padded, at heads of 16 and 32) whose byte
    stride a tensor map takes (a multiple of 16)."""
    return (head_dim in HEAD_DIMS and 1 <= s <= MAX_SEQ
            and w % head_dim == 0
            and 3 * (w // head_dim) * kernel_head_dim(head_dim) * 2 % 16 == 0)


def sm90_bwd_fits(s, w, head_dim):
    """Whether K10's kernels take qkv (B, s, 3w) and g (B, s, w): a
    head_dim they are built for, S <= SM90_MAX_SEQ_BWD, the dkv block's
    shared memory within a block's, and 16-byte row strides."""
    return (head_dim in BWD_HEAD_DIMS and 1 <= s <= SM90_MAX_SEQ_BWD
            and w % head_dim == 0
            and (w // head_dim) * kernel_head_dim(head_dim) * 2 % 16 == 0
            and sm90_dkv_smem(s, head_dim) <= SM90_BLOCK_SMEM)


def check_attention_bwd_shape(name, qkv, g, heads, head_dim):
    """Raise unless K10 takes qkv (B, S, 3·heads·head_dim) and g (B, S, W),
    both bf16, at a shape `sm90_bwd_fits` admits."""
    b, s, w3 = qkv.shape
    if (qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16
            or w3 != 3 * heads * head_dim or g.shape != (b, s, w3 // 3)
            or not sm90_bwd_fits(s, w3 // 3, head_dim)):
        raise ValueError(f"{name} takes bf16 qkv (B, S, 3W) and g (B, S, W) "
                         f"with head_dim in {BWD_HEAD_DIMS} and S <= "
                         f"{SM90_MAX_SEQ_BWD}, got {qkv.dtype} "
                         f"{tuple(qkv.shape)}, {g.dtype} {tuple(g.shape)}, "
                         f"heads {heads} head_dim {head_dim}")


def attention_qkv_reference(qkv, heads, head_dim, scale=None,
                            logit_bias=None, out_dtype=None):
    """(B, S, 3W) fused [q | k | v] → (B, S, W), full softmax with an
    optional (B, S) per-key additive logit bias (ToMe proportional
    attention). Scores and softmax in f32 from the operands' values; the
    probabilities are cast to v's dtype before the value product, whose
    f32 sum is returned in v's dtype (JAX's einsum semantics), or in
    out_dtype (the whole-layer kernel K7 quantises the f32 sum)."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, w3 = qkv.shape
    w = w3 // 3
    q = qkv[..., :w].reshape(b, s, heads, head_dim)
    k = qkv[..., w:2 * w].reshape(b, s, heads, head_dim)
    v = qkv[..., 2 * w:].reshape(b, s, heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_bias is not None:
        logits = logits + logit_bias[:, None, None, :].float()
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return o.to(out_dtype or v.dtype).reshape(b, s, w)


def _attention_qkv_cuda(qkv, heads, head_dim, scale, logit_bias):
    check_attention_shape("K9", qkv, heads, head_dim)
    b, s, _ = qkv.shape
    if not sm90_fwd_fits(s, heads * head_dim, head_dim):
        raise ValueError(f"K9 has no kernel for S {s}, head_dim {head_dim}")
    hk = kernel_head_dim(head_dim)
    if hk != head_dim:
        qkv = pad_heads(qkv, heads, head_dim, hk)
    out = torch.empty((b, s, heads * hk), dtype=torch.bfloat16,
                      device=qkv.device)
    bias = None
    if logit_bias is not None:
        # rows of whole 64-key tiles: each TMA box of the bias starts on a
        # 16-byte boundary
        pad = -s % SM90_TILE_ROWS
        bias = torch.nn.functional.pad(logit_bias.float(),
                                       (0, pad)).contiguous()
    _build.call("tpudf_attention_qkv_sm90", qkv.contiguous(), bias, out, b,
                s, heads, hk, float(scale))
    LAUNCHES.hit(KERNEL)
    return out if hk == head_dim else unpad_heads(out, heads, head_dim, hk)


def attention_qkv(qkv, heads, head_dim, scale=None, *, logit_bias=None):
    """(B, S, 3W) → (B, S, W). logit_bias: optional (B, S) f32 per-key
    bias. CPU tensors take the plain twin; CUDA tensors launch K9 or
    raise."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not qkv.is_cuda:
        return attention_qkv_reference(qkv, heads, head_dim, scale,
                                       logit_bias)
    return _attention_qkv_cuda(qkv, heads, head_dim, scale, logit_bias)


def _quant_amax(t, amax):
    """clip(round(t · 127/amax), ±127) in f32, as `_one_head` codes."""
    return torch.clamp(torch.round(t * (127.0 / amax)), -127, 127)


def attention_qkv_int8_reference(qkv, heads, head_dim, scale=None, *,
                                 q_block=INT8_Q_BLOCK):
    """Plain twin of 9b: (B, S, 3W) → (B, S, W) in qkv's dtype, the
    arithmetic of `_one_head(int8_attn=True)` with the int8 products as
    exact f32 sums of small integers. q_block: the rows over which aq is
    taken (JAX's min(q_block, S)); the smoke run plants a fault by
    changing it."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, w3 = qkv.shape
    w = w3 // 3
    qb = min(q_block, s)
    sp = -(-s // qb) * qb

    def heads_first(t):                     # (B, S, W) → (B, H, S, d) f32
        return t.reshape(b, -1, heads, head_dim).transpose(1, 2).float()

    q, k, v = (heads_first(qkv[..., i * w:(i + 1) * w]) for i in range(3))
    qp = torch.nn.functional.pad(q, (0, 0, 0, sp - s))
    qblk = qp.reshape(b, heads, sp // qb, qb, head_dim)
    aq = torch.amax(torch.abs(qblk), dim=(-2, -1), keepdim=True) + 1e-6
    q8 = _quant_amax(qblk, aq).reshape(b, heads, sp, head_dim)[:, :, :s]
    aq = torch.repeat_interleave(aq.reshape(b, heads, -1), qb,
                                 dim=-1)[..., :s, None]
    ak = torch.amax(torch.abs(k), dim=(-2, -1), keepdim=True) + 1e-6
    av = torch.amax(torch.abs(v), dim=(-2, -1), keepdim=True) + 1e-6
    acc = torch.matmul(q8, _quant_amax(k, ak).transpose(-1, -2))
    sc = acc * ((aq * ak) / (127.0 * 127.0) * scale)
    e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    ap = torch.amax(p, dim=-1, keepdim=True) + 1e-20
    p8 = torch.round(p * (127.0 / ap))
    # the int32 sum of p8 · v8 rounded once to f32, as JAX and the kernel
    # round it: exact in f64 (it passes 2^24 past S = 1040)
    pv = torch.matmul(p8.double(), _quant_amax(v, av).double()).float()
    o = pv * (ap * (av / (127.0 * 127.0)))
    return o.transpose(1, 2).reshape(b, s, w).to(qkv.dtype)


def vt_pos(x):
    """Where key x of a 64-key tile lies in a row of 9b's transposed v
    codes (csrc/attention_i8.cu `vt_pos`): keys 2t, 2t + 1, 8 + 2t, 9 + 2t
    of each 16 at 4t .. 4t + 3, the bytes lane t's A fragment holds."""
    y = x & 15
    return (x & ~15) + 4 * ((y & 7) >> 1) + 2 * (y >> 3) + (y & 1)


def i8_pad(s):
    """9b's S_pad: S rounded up to whole 128-row items."""
    return -(-s // I8_ROWS) * I8_ROWS


def attention_i8_codes_reference(qkv, heads, head_dim,
                                 q_block=INT8_Q_BLOCK):
    """Plain version of 9b's pre-pass on any device: (B, S, 3 heads
    head_dim) → (amax (B, heads, nqb + 2) f32: |q| + 1e-6 per query block,
    then |k| and |v| over S; q8, k8 (B, heads, S_pad, head_dim) int8; v8t
    (B, heads, head_dim, S_pad) int8 with key x at `vt_pos(x)`), zeros past
    S, the codes clip(round(t · (127 / a)), ±127) of `_one_head`."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    qb = min(q_block, s)
    sp = i8_pad(s)
    t = qkv.float().reshape(b, s, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]                     # (B, H, S, d)
    nqb = -(-s // qb)
    qblk = torch.nn.functional.pad(q, (0, 0, 0, nqb * qb - s)).reshape(
        b, heads, nqb, qb, head_dim)
    aq = torch.amax(qblk.abs(), dim=(-2, -1)) + 1e-6        # (B, H, nqb)
    ak = torch.amax(k.abs(), dim=(-2, -1)) + 1e-6
    av = torch.amax(v.abs(), dim=(-2, -1)) + 1e-6
    amax = torch.cat([aq, ak[..., None], av[..., None]], -1)

    def codes(t_, a):
        # 127 / a by the IEEE division (the kernel's and JAX's; 127.0 / a
        # would be torch's reciprocal times 127, one rounding more)
        c = torch.clamp(torch.round(t_ * torch.div(a.new_tensor(127.0), a)),
                        -127, 127)
        return torch.nn.functional.pad(c, (0, 0, 0, sp - s)).to(torch.int8)

    q8 = codes(q, torch.repeat_interleave(aq, qb, -1)[..., :s, None])
    k8 = codes(k, ak[..., None, None])
    v8 = codes(v, av[..., None, None])
    pos = torch.tensor([vt_pos(x) for x in range(sp)], device=qkv.device)
    v8t = torch.empty_like(v8.transpose(-1, -2))
    v8t[..., pos] = v8.transpose(-1, -2)
    return amax.contiguous(), q8.contiguous(), k8.contiguous(), v8t


def i8dyn_prepass(qkv, heads, hk, qb):
    """9b's pre-pass launch at a head width of I8_SM90_HEAD_DIMS: qkv (B,
    S, 3 heads hk) bf16 → (amax, q8, k8, v8t) as
    `attention_i8_codes_reference` gives them (torch.empty scratch, 3 B
    heads hk S_pad bytes of codes)."""
    b, s, _ = qkv.shape
    sp = i8_pad(s)
    dev = qkv.device
    amax = torch.empty((b, heads, -(-s // qb) + 2), dtype=torch.float32,
                       device=dev)
    q8 = torch.empty((b, heads, sp, hk), dtype=torch.int8, device=dev)
    k8 = torch.empty_like(q8)
    v8t = torch.empty((b, heads, hk, sp), dtype=torch.int8, device=dev)
    _build.call("tpudf_attention_i8_prepass", qkv, amax, q8, k8, v8t, b, s,
                heads, hk, qb)
    return amax, q8, k8, v8t


def i8dyn_main(codes, b, s, heads, hk, qb, scale):
    """9b's main pass launch (int8 wgmma) on the pre-pass's (amax, q8, k8,
    v8t) → (B, S, heads hk) bf16."""
    amax, q8, k8, v8t = codes
    out = torch.empty((b, s, heads * hk), dtype=torch.bfloat16,
                      device=q8.device)
    _build.call("tpudf_attention_i8dyn_sm90", q8, k8, v8t, amax, out, b, s,
                heads, hk, qb, float(scale))
    return out


def _attention_qkv_int8_cuda(qkv, heads, head_dim, scale):
    check_attention_shape("9b", qkv, heads, head_dim)
    b, s, _ = qkv.shape
    hk = kernel_head_dim(head_dim)
    if hk != head_dim:          # zero columns: amax and the codes unchanged
        qkv = pad_heads(qkv, heads, head_dim, hk)
    qkv = qkv.contiguous()
    qb = min(INT8_Q_BLOCK, s)
    if hk in I8_SM90_HEAD_DIMS:
        out = i8dyn_main(i8dyn_prepass(qkv, heads, hk, qb), b, s, heads, hk,
                         qb, scale)
    else:
        amax = torch.empty((b, heads, -(-s // qb) + 2), dtype=torch.float32,
                           device=qkv.device)
        out = torch.empty((b, s, heads * hk), dtype=torch.bfloat16,
                          device=qkv.device)
        _build.call("tpudf_attention_i8dyn", qkv, amax, out, b, s, heads, hk,
                    qb, float(scale))
    LAUNCHES.hit(KERNEL_INT8)
    return out if hk == head_dim else unpad_heads(out, heads, head_dim, hk)


def attention_qkv_int8(qkv, heads, head_dim, scale=None):
    """(B, S, 3W) → (B, S, W) with dynamic-int8 QKᵀ and p·v (no logit
    bias, no gradient: JAX's int8_attn mode is inference-only). CPU
    tensors take the plain twin; CUDA tensors launch 9b or raise."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not qkv.is_cuda:
        return attention_qkv_int8_reference(qkv, heads, head_dim, scale)
    return _attention_qkv_int8_cuda(qkv, heads, head_dim, scale)


def attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale=None, *,
                                jax_head_dim=None):
    """Plain twin of K10: (B, S, 3W) qkv and (B, S, W) cotangent g → dqkv
    (B, S, 3W) in qkv's dtype, laid out [dq | dk | dv]. P and dS are cast
    to qkv's dtype (bf16 on the card) only for the products that read
    them, as the TPU kernel casts them. jax_head_dim: the wrapper's routing
    argument, which the twin does not need."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, w3 = qkv.shape
    w = w3 // 3
    dt = qkv.dtype

    def heads_first(t):                     # (B, S, W) → (B, H, S, d) f32
        return t.reshape(b, s, heads, head_dim).transpose(1, 2).float()

    q, k, v = (heads_first(qkv[..., i * w:(i + 1) * w]) for i in range(3))
    gh = heads_first(g)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    dsb = ds.to(dt).float()
    dq = torch.matmul(dsb, k)
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    return torch.cat([t.transpose(1, 2).reshape(b, s, w)
                      for t in (dq, dk, dv)], dim=-1).to(dt)


def attention_qkv_bwd_fits(s, w, head_dim):
    """JAX's choice of the Pallas backward (`_fused_qkv_with_vjp.bwd`,
    tpudf/ops/attention.py:388-393) for qkv (B, s, 3w): the (S, S) f32
    tile plus the qkv and g rows fit 12 MiB, head_dim divides or is a
    multiple of the 128 lanes, S % 8 == 0, W % 128 == 0, and
    TPUDF_PALLAS_ATTN_BWD is not "0" (read per call, as JAX reads it per
    trace). False: JAX's XLA-recompute VJP."""
    enabled = os.environ.get("TPUDF_PALLAS_ATTN_BWD", "1") != "0"
    fits = s * s * 4 + 2 * s * 3 * w * 2 + s * w * 2 <= BWD_FIT_BYTES
    lane_ok = head_dim % 128 == 0 or 128 % head_dim == 0
    return bool(enabled and fits and lane_ok and s % 8 == 0
                and w % 128 == 0)


def attention_qkv_bwd_twin_vjp(qkv, g, heads, head_dim, scale=None):
    """dqkv as the VJP of the forward's twin (`attention_qkv_reference`)
    recomputed under autograd: JAX's XLA route, `jax.vjp(_reference_qkv)`,
    where its Pallas backward does not fit."""
    scale = scale if scale is not None else head_dim ** -0.5
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        o = attention_qkv_reference(x, heads, head_dim, scale)
        (d,) = torch.autograd.grad(o, x, g)
    return d


def _attention_qkv_bwd_cuda(qkv, g, heads, head_dim, scale):
    check_attention_bwd_shape("K10", qkv, g, heads, head_dim)
    b, s, _ = qkv.shape
    hk = kernel_head_dim(head_dim)
    if hk != head_dim:          # the padded columns of dqkv come out 0
        qkv = pad_heads(qkv, heads, head_dim, hk)
        g = pad_heads(g, heads, head_dim, hk)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32,
                        device=qkv.device)
    _build.call("tpudf_attention_qkv_bwd_sm90", qkv.contiguous(),
                g.contiguous(), dqkv, stats, b, s, heads, hk, float(scale))
    LAUNCHES.hit(KERNEL_BWD)
    return dqkv if hk == head_dim else unpad_heads(dqkv, heads, head_dim, hk)


def attention_qkv_bwd(qkv, g, heads, head_dim, scale=None, *,
                      jax_head_dim=None):
    """dqkv of K9 at qkv for the output cotangent g, routed as JAX routes
    it (`attention_qkv_bwd_fits`): where its Pallas backward runs, a CUDA
    tensor launches K10 (or raises) and a CPU tensor takes K10's twin;
    elsewhere the VJP of the forward's twin (counted on the card).
    jax_head_dim: the head_dim of JAX's graph where the caller zero-padded
    the heads (so400m's 72 → 128); JAX decides on the unpadded width and
    head_dim, and at 72 its forward already leaves Pallas."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, _ = qkv.shape
    d_jax = jax_head_dim or head_dim
    if not attention_qkv_bwd_fits(s, heads * d_jax, d_jax):
        if qkv.is_cuda:
            LAUNCHES.hit(KERNEL_BWD_TWIN)
        return attention_qkv_bwd_twin_vjp(qkv, g, heads, head_dim, scale)
    if not qkv.is_cuda:
        return attention_qkv_bwd_reference(qkv, g, heads, head_dim, scale)
    return _attention_qkv_bwd_cuda(qkv, g, heads, head_dim, scale)


class _FusedQKVAttention(torch.autograd.Function):
    """fwd(qkv) forward, bwd(qkv, g) backward; only qkv is saved."""

    @staticmethod
    def forward(ctx, qkv, heads, head_dim, scale, fwd, bwd, bwd_kw):
        ctx.save_for_backward(qkv)
        ctx.args = (heads, head_dim, scale, bwd, bwd_kw)
        return fwd(qkv, heads, head_dim, scale)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        heads, head_dim, scale, bwd, bwd_kw = ctx.args
        return (bwd(qkv, g.contiguous(), heads, head_dim, scale, **bwd_kw),
                None, None, None, None, None, None)


def attention_qkv_vjp(qkv, heads, head_dim, scale=None, *, fwd=attention_qkv,
                      bwd=attention_qkv_bwd, logit_bias=None,
                      jax_head_dim=None):
    """The tower's differentiable attention: fwd (K9 or its twin) forward
    and bwd (K10 or its twin, routed as JAX routes; `jax_head_dim` as in
    `attention_qkv_bwd`) backward. With a logit bias (ToMe, serving only)
    it calls fwd directly, as JAX sends biased attention to its XLA
    reference: the CPU twin is then differentiated by autograd, and a CUDA
    tensor that needs a gradient raises, since no kernel computes that
    gradient."""
    scale = scale if scale is not None else head_dim ** -0.5
    if logit_bias is not None:
        if qkv.is_cuda and qkv.requires_grad and torch.is_grad_enabled():
            raise ValueError("attention with a logit bias has no backward "
                             "kernel; it is a serving path")
        return fwd(qkv, heads, head_dim, scale, logit_bias=logit_bias)
    bwd_kw = {} if jax_head_dim is None else {"jax_head_dim": jax_head_dim}
    return _FusedQKVAttention.apply(qkv, heads, head_dim, scale, fwd, bwd,
                                    bwd_kw)


# ---------------------------------------------------------- kernels 11, 12

def attention_reference(q, k, v, scale=None):
    """Plain twin of kernel 11 (JAX's `attention_reference`): q (B, H, Sq,
    D), k, v (B, H, Skv, D) → (B, H, Sq, D) in v's dtype; scores and softmax
    in f32, the probabilities cast to v's dtype, f32 sums."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _reference_bshd(q, k, v, scale=None):
    """Plain twin of kernel 12 (JAX's `_reference_bshd`): the same in the
    (B, S, H, D) layout."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def plain_fits(dtype, head_dim):
    """Whether kernels 11 and 12 are built for q, k, v of this dtype and
    head_dim: bf16 at PLAIN_HEAD_DIMS (the wgmma kernel), f32 up to
    PLAIN_F32_MAX_HEAD_DIM (the SIMT kernel). At these head_dims every row
    stride of a contiguous bf16 tensor is a multiple of 16 bytes, as a
    tensor map needs."""
    if dtype == torch.bfloat16:
        return head_dim in PLAIN_HEAD_DIMS
    return dtype == torch.float32 and head_dim <= PLAIN_F32_MAX_HEAD_DIM


def plain_sm90_smem(head_dim):
    """Shared bytes of the bf16 kernel's block (`PlainSmem`): two Q buffers
    of SM90_BLOCK_ROWS rows and the ring's stages of a K and a V tile of
    SM90_TILE_ROWS rows (6 on the 64-wide tile of heads of 64, 4 on the
    80-wide one of heads of 72 and the 128-wide one of heads of 128), the
    barriers, and 1 KB for the alignment of the swizzled tiles."""
    width = {64: 64, 72: 80}.get(head_dim, 128)
    tile = lambda rows: rows * width * 2
    stages = 6 if width == 64 else 4
    return (2 * tile(SM90_BLOCK_ROWS) + stages * 2 * tile(SM90_TILE_ROWS)
            + 8 * (4 + 2 * stages) + 1024)


def plain_f32_smem(head_dim):
    """Shared bytes of the f32 kernel's block of PLAIN_F32_ROWS query rows
    (`F32Smem`): Q^T (DP columns of rows + 4), a K and a V tile (64 keys of
    DP + 4 floats), p^T (64 keys of rows + 4) and the row statistics of the
    block's two key halves, DP = 64 for head_dim <= 64, else 128."""
    dp, rows = (64 if head_dim <= 64 else 128), PLAIN_F32_ROWS
    return 4 * (dp * (rows + 4) + 2 * 64 * (dp + 4) + 64 * (rows + 4)
                + 4 * rows)


def _plain_dims(q, k, bshd):
    """(B, H, Sq, Skv, D) of q and k in their layout."""
    if bshd:
        b, sq, h, d = q.shape
        return b, h, sq, k.shape[1], d
    b, h, sq, d = q.shape
    return b, h, sq, k.shape[2], d


def check_plain_attention(name, q, k, v, bshd=False):
    """Raise unless kernels 11 (bshd False) and 12 take q, k, v: 4-D, one
    dtype, bf16 with head_dim in PLAIN_HEAD_DIMS or f32 with head_dim <=
    PLAIN_F32_MAX_HEAD_DIM, k and v of one shape matching q's batch, heads
    and head_dim, Skv >= 1, and each tensor under 2^31 elements."""
    ok = q.dim() == 4 and k.shape == v.shape and k.dim() == 4
    if ok:
        b, h, sq, skv, d = _plain_dims(q, k, bshd)
        kb, kh, _, _, kd = _plain_dims(k, k, bshd)
        ok = ((kb, kh, kd) == (b, h, d) and skv >= 1
              and q.dtype == k.dtype == v.dtype
              and max(q.numel(), k.numel()) < 2 ** 31
              and plain_fits(q.dtype, d))
    if not ok:
        raise ValueError(
            f"{name} takes q, k, v of one dtype, bf16 with head_dim in "
            f"{PLAIN_HEAD_DIMS} or f32 with head_dim <= "
            f"{PLAIN_F32_MAX_HEAD_DIM}, k and v of one shape, got "
            f"{q.dtype} {tuple(q.shape)}, {k.dtype} {tuple(k.shape)}, "
            f"{v.dtype} {tuple(v.shape)}")


def _plain_strides(t, bshd):
    """(image, head, row) element strides of a contiguous tensor."""
    return ((t.stride(0), t.stride(2), t.stride(1)) if bshd
            else (t.stride(0), t.stride(1), t.stride(2)))


def _attention_plain_cuda(q, k, v, scale, bshd):
    """One launch of kernel 11 (bshd False) or 12."""
    name = "kernel 12" if bshd else "kernel 11"
    check_plain_attention(name, q, k, v, bshd)
    b, h, sq, skv, d = _plain_dims(q, k, bshd)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    args = (q, k, v, out, b, h, sq, skv, d, *_plain_strides(q, bshd),
            *_plain_strides(k, bshd), float(scale))
    _build.call("tpudf_attention_plain_f32" if q.dtype == torch.float32
                else "tpudf_attention_plain_sm90", *args)
    LAUNCHES.hit(KERNEL_BSHD if bshd else KERNEL_PLAIN)
    return out


def _attention_fwd(q, k, v, *, scale):
    if not q.is_cuda or q.shape[2] > PALLAS_MAX_SQ:
        return attention_reference(q, k, v, scale)
    return _attention_plain_cuda(q, k, v, scale, bshd=False)


def _attention_bshd_fwd(q, k, v, *, scale):
    if not q.is_cuda:
        return _reference_bshd(q, k, v, scale)
    return _attention_plain_cuda(q, k, v, scale, bshd=True)


def attention(q, k, v, scale=None):
    """Multi-head attention, q (B, H, Sq, D), k, v (B, H, Skv, D) → (B, H,
    Sq, D), JAX's `attention`: CPU tensors take the twin; CUDA tensors
    launch kernel 11 or raise, but for Sq > 4096, which JAX sends to XLA
    and the port to the twin. Differentiable through the twin's VJP."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return with_twin_vjp(_attention_fwd, attention_reference, q, k, v,
                         scale=float(scale))


def attention_bshd(q, k, v, scale=None):
    """Multi-head attention in the (B, S, H, D) layout → (B, Sq, H, D),
    JAX's `attention_bshd`: CPU tensors take the twin; CUDA tensors launch
    kernel 12 or raise. Differentiable through the twin's VJP."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return with_twin_vjp(_attention_bshd_fwd, _reference_bshd, q, k, v,
                         scale=float(scale))
