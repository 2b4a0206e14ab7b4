"""The static-W8A8 block's kernels: the attention sublayer K1, its split
halves K5 and K6, and the whole layer K7.

K1 (`attn_sublayer_int8`): x → LN (f32 E[x²]−E[x]²) → static int8 quant →
int8 QKV GEMM (int32 accumulate) → dequant + bias → bf16 qkv → per-image,
per-head full softmax with an optional per-key bias log(size) → p cast to
bf16 for AV → int8 quant → int8 out-proj → dequant + bias + residual.
Replaces tpudf/ops/int8_block.py `_attn_sublayer_kernel`. The CUDA kernels
live in `csrc/layernorm.cu`, `csrc/int8_gemm_sm90.cu` and
`csrc/attention_sm90.cu` and run as four
launches: LN + quant (one bf16 read, one int8 write), the QKV GEMM, the
attention, the out-proj GEMM. The TPU kernel kept the int8 LN output, the
bf16 qkv and the attention output in VMEM; here they pass through device
memory (int8, bf16, int8), and keeping them on-chip is later work. On the
card the GEMMs are bound by tensor-core operations (wgmma s8, int32
accumulate). The attention (`attention_i8`) is K9's block on wgmma and TMA
with int8 codes of the f32 o out, on kernels 11 and 12's softmax sequence
(ex2 on scores that carry log2 e, p = e·r): heads of 64, 128 and 256 on tiles of
their width, 32 and fewer zero-padded to 64, the wide heads on their own
kernel, and so400m's heads of 72 (padded to 128 in qkv, `live` = 72) on an
80-wide tile whose columns 72-79 are read as they are and whose codes in
columns 80-127 are 0. Its twin is `ln_qkv_reference` then
`attn_out_reference`, the JAX package's reference forms.

K5 (`ln_qkv_int8`, replacing `_ln_qkv_kernel`): x → LN → quant → int8 QKV
→ dequant + bias, ONE launch: the int8 GEMM's persistent wgmma kernel
(`csrc/int8_gemm_sm90.cu`) with its A operand from an LN panel. A block
normalises and quantises a row tile's 128 rows into shared memory once,
in the layout wgmma reads, then walks a run of that row tile's 128-wide
column tiles with only the weight streaming through its TMA ring; each
row tile's columns are split in `k5_splits` runs so that the B = 8 cores'
few row tiles fill the card (`k5_units`: the walk). The int8 LN output
never reaches device memory. Past K5_MAX_WIDTH (1280: a 128-row panel of
W bytes leaves too few weight stages beside it, and the panel's rows sit
five chunks a lane) it runs as K8 + the int8 GEMM, its bit-equal form,
counted as KERNEL_LN_QKV_SPLIT. Twin: `ln_qkv_reference`.

K6 (`attn_out_int8`, replacing `_attn_out_kernel`): qkv + residual x →
attention → int8 quant of the f32 output → int8 out-proj → dequant + bias
+ residual, ONE launch on wgmma and TMA (`csrc/attention.cu`, the cluster
tile of `csrc/attn_out_sm90.cuh`): a cluster of up to 8 CTAs takes one
128-row tile of one image, each CTA a share of the heads (K1's attention
block, codes into every CTA's shared-memory o panel through distributed
shared memory) and then a share of the out-projection's 128-column tiles
against its whole panel (`k6_plan`); its output equals K1's attention
launch followed by the int8 GEMM in GEMM_RESIDUAL mode bit for bit. At
the wide heads (384 to 1280), and wherever the (128 x Wa) o panel does
not fit a block beside the attention (Wa past K6_MAX_WA): those two
launches, K1's attention kernel then that GEMM, counted as
KERNEL_ATTN_OUT_SPLIT (`k6_route`). With a logit bias, or where
JAX's VMEM estimate does not fit (`attn_out_int8_fits`: so400m-512's S =
1024, Wa = 2048), the JAX function takes its reference route, and so does
this one: K9 (with the bias), or without a bias and under
TPUDF_INT8_ATTN=1 kernel 9b, then the int8 out-proj GEMM with the
residual epilogue. Twin: `attn_out_reference` (it quantises the
bf16-rounded attention output, the JAX reference form; the kernel
quantises the f32 one, the TPU kernel's).

The routing predicates are JAX's own decisions from shapes, copied:
`attn_sublayer_int8_fits` (K1, else K5 + `attn_out_int8`),
`attn_out_int8_fits` (K6, else the reference route) and
`layer_int8_eligible` (K7, else FPP; JAX's structural conditions and its
13 MB VMEM fit). Which form of a kernel runs where JAX's decision admits
it is the port's own choice (`k6_route`, `k7_form`).

K7 (`siglip_layer_int8`, replacing `_layer_kernel`): the whole layer in
ONE cooperative launch of clusters (`csrc/layer_int8.cu`) whose four
grid-synchronised phases run on the sm90 device functions: K5's LN panel
and the int8 wgmma product (LN1 + QKV), K6's cluster tile with an f32
out (the attention sublayer's residual stays f32 into LN2 and the final
add), the LN panel built from those f32 rows (LN2 + fc1 + GELU + quant),
and fc2 with both operands by TMA and the f32 residual. It takes heads of
1 to 128 on K6's tiles and panel (padded as `k6_tile` pads them), any S,
and W up to K5_MAX_WIDTH, where the o panel fits (`k7_form`); elsewhere
in JAX's domain (heads of 256 and wider, Wa past K6_MAX_WA or past two
ring stages beside it, W past the panel)
K7's split form runs the same arithmetic in six or seven launches (K5 or
K8 + the GEMM; the attention with K9's exact softmax into int8 codes; the
out-projection into the f32 x1; the LN pass over f32 rows; fc1 + GELU;
fc2 on the f32 x1), counted as KERNEL_LAYER_SPLIT. JAX has no reference
form of it (off a TPU it returns None); the twin
`siglip_layer_int8_reference` is written from `_layer_kernel`'s math.
"""

from __future__ import annotations

import os

import torch

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.attention import (HEAD_DIMS, MAX_ROWS, MAX_SEQ,
                                       SM90_BLOCK_SMEM, SM90_TILE_ROWS,
                                       WIDE_HEAD_DIMS,
                                       attention_qkv_reference,
                                       check_attention_shape,
                                       kernel_head_dim, pad_heads,
                                       unpad_heads)
from tpudf_torch.ops.layernorm import (MAX_WIDTH, REG_WIDTH, ln_quant_cuda,
                                       ln_quant_f32_cuda, ln_rows_f32)
from tpudf_torch.ops.quant import (KERNEL_GEMM, f32_scalar, int8_mm,
                                   quant_rows, transposed)
from tpudf_torch.utils.nn import gelu_tanh

KERNEL = "attn_sublayer_int8"
KERNEL_LN_QKV = "ln_qkv_int8"
KERNEL_ATTN_OUT = "attn_out_int8"
KERNEL_ATTN_OUT_SPLIT = "attn_out_int8_split"   # K6 as two launches
KERNEL_LN_QKV_SPLIT = "ln_qkv_int8_split"       # K5 as K8 + the GEMM
KERNEL_LAYER = "siglip_layer_int8"
KERNEL_LAYER_SPLIT = "siglip_layer_int8_split"  # K7 in separate launches
K5_MAX_WIDTH = REG_WIDTH    # K5's and K7's LN panel: a row five chunks a
                            # lane (csrc/common.cuh kLnMaxWidth)
# K6's widest Wa at each head_dim its tile runs (csrc/attn_out_sm90.cuh:
# the (128 x Wa) int8 panel beside the Q buffer and a stage of K and V
# tiles within a block's shared memory, `k6_smem`); None: the wide heads.
# Past it K6 runs as two launches (`k6_route`), K7 as its split form
K6_MAX_WA = {16: 1536, 32: 1536, 64: 1024, 128: 768, 256: 768,
             **dict.fromkeys(WIDE_HEAD_DIMS)}
K6_MIN_HEAD_DIM = 16        # the panel's narrowest head: narrower ones are
                            # padded to it
K6_MAX_CLUSTER = 8          # csrc/attn_out_sm90.cuh kAoMaxCluster
I8_ATTN_NARROW = 80         # K1's tile for a head of 65-80 live of 128


def k6_head_dim(head_dim):
    """The head_dim K6's panel holds `head_dim` at: at least
    K6_MIN_HEAD_DIM (narrower heads zero-padded: zero columns add nothing
    to q·k, p·v or the out-projection)."""
    return max(head_dim, K6_MIN_HEAD_DIM)


def k6_tile(head_dim):
    """(tile width, live columns a head) K6's cluster tile runs a head of
    `head_dim` at: the attention on K1's tile (heads of 32 and fewer
    zero-padded to 64), the panel `k6_head_dim` columns a head."""
    live = k6_head_dim(head_dim)
    return kernel_head_dim(live), live


def k6_smem(tile, wa):
    """K6's dynamic shared memory a block (`ao_layout`): the panel of
    ceil(Wa / 128) slices of 16 KB, the Q buffer (128 x tile bf16), as many
    stages of a K and a V tile (64 x tile bf16 each) as fit up to 6 / 4 / 2
    (tile 64 / 128 / 256), the barriers and the alignment; None where not
    one stage fits."""
    ahead = -(-wa // 128) * 16384 + 128 * tile * 2
    stride = 2 * 64 * tile * 2
    stages = min((SM90_BLOCK_SMEM - 1024 - 256 - ahead) // stride,
                 {64: 6, 128: 4, 256: 2}[tile])
    if stages < 1:
        return None
    w_stages = min((128 * tile * 2 + stages * stride) // 16384, 8)
    return ahead + stages * stride + 8 * (2 + 2 * stages + 2 * w_stages) + 1024


# the clusters of 1 .. 8 CTAs of K6's kernel an H100 SXM holds at a time
# (cudaOccupancyMaxActiveClusters at every K6 shape: one CTA an SM, and
# fewer than 132 / C where the GPCs' SMs do not divide by C; chip_smoke.py
# phase 2l, NVIDIA H100 80GB HBM3)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def k6_cluster(b, s, heads, tile, live, width, waves=None):
    """K6's cluster size (`ao_cluster`): the C in 1 .. 8 (at most `heads`)
    that minimises the waves of clusters (waves[C] at a time, the card's
    occupancy; H100_CLUSTERS by default) over the B·ceil(S / 128) row tiles
    times a CTA's work: ceil(heads / C) heads of 6 · S₆₄ · tile and
    ceil(W / 128 / C) column tiles of 64 · Wa; the smallest such C (at
    B = 8: 6 at base-256, 8 at large-384)."""
    waves = waves or H100_CLUSTERS
    units = b * -(-s // 128)
    keys = -(-s // 64) * 64
    best, best_cost = 1, None
    for c in range(1, min(K6_MAX_CLUSTER, heads) + 1):
        cost = -(-units // max(waves[c], 1)) * (
            -(-heads // c) * 6 * keys * tile
            + -(-(width // 128) // c) * 64 * heads * live)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def k6_plan(b, s, heads, tile, live, width, waves=None):
    """K6's launch: per CTA (image, first row of its 128-row tile, rank in
    its cluster, its heads, its 128-column tiles of the out-projection):
    cluster u takes row tile u (image u // ceil(S / 128)), rank k heads k,
    k + C, ... and column tiles k, k + C, ..."""
    c = k6_cluster(b, s, heads, tile, live, width, waves)
    n_qt = -(-s // 128)
    return [(u // n_qt, (u % n_qt) * 128, k, list(range(k, heads, c)),
             list(range(k, width // 128, c)))
            for u in range(b * n_qt) for k in range(c)]


def i8_attn_tile(head_dim, live=None):
    """(tile width, head stride in qkv's columns) K1's attention kernel
    runs a head of `head_dim` columns at, `live` of them holding values
    and the rest exact zeros (so400m's 72 of 128; None: all live): an
    80-wide tile over the first 80 of 128 columns where 64 < live <= 80,
    else `kernel_head_dim` (heads of 32 and fewer zero-padded to 64).
    Raises on a live width outside 1 .. head_dim."""
    if live is None:
        live = head_dim
    if not 1 <= live <= head_dim:
        raise ValueError(f"K1: {live} live columns do not fit a head of "
                         f"{head_dim}")
    if head_dim == 128 and 64 < live <= I8_ATTN_NARROW:
        return I8_ATTN_NARROW, 128
    hk = kernel_head_dim(head_dim)
    return hk, hk
MiB = 1024 * 1024


def _lane_ok(head_dim):
    return head_dim % 128 == 0 or 128 % head_dim == 0


def attn_sublayer_int8_fits(b, s, w, wa, head_dim):
    """JAX `attn_sublayer_int8`'s test for its fused kernel
    (tpudf/ops/int8_block.py:197-219, formula copied): lane-aligned heads,
    W, Wa and S aligned, and the VMEM estimate of a program of `group`
    images within 48 MB. Otherwise JAX runs `ln_qkv_int8` then
    `attn_out_int8`."""
    group = 1
    for g in (16, 8, 4, 2):
        if b % g == 0 and g * s <= 512:
            group = g
            break
    vmem = (4 * w * wa + group * s * 3 * wa * 2 + s * s * 4
            + 2 * group * s * w * 4 + group * s * wa * 4)
    return (_lane_ok(head_dim) and w % 128 == 0 and wa % 128 == 0
            and s % 8 == 0 and vmem <= 48 * MiB)


def attn_out_int8_fits(s, wa, wm, head_dim, q_block=256):
    """JAX `attn_out_int8`'s test for its fused kernel
    (tpudf/ops/int8_block.py:456-468, formula copied): lane-aligned heads,
    Wa and W aligned, S % 8 == 0, and the VMEM estimate within 13 MB
    (base-256 and large-384 fit; so400m-512's S = 1024, Wa = 2048 does
    not). Otherwise, and always with a logit bias, JAX takes
    `_attn_out_reference`."""
    qb0 = min(q_block, s)
    vmem = (2 * (qb0 * wa * 2 + 2 * s * wa * 2 + qb0 * wm * 2)
            + wa * wm + qb0 * s * 4 + qb0 * wa * 4)
    return (_lane_ok(head_dim) and wa % 128 == 0 and wm % 128 == 0
            and s % 8 == 0 and vmem <= 13 * MiB)


def _route_attention(qkv, heads, head_dim, scale, logit_bias, kernels):
    """The attention of JAX's `_attn_out_reference`, from `kernels`
    (routes.KERNELS on the card, routes.TWINS for the twin): dynamic int8
    (9b) without a logit bias under TPUDF_INT8_ATTN=1, which is read here
    and nowhere else, else the bf16 attention (K9) with the bias."""
    if logit_bias is None and os.environ.get("TPUDF_INT8_ATTN") == "1":
        return kernels.attention_qkv_int8(qkv, heads, head_dim, scale)
    return kernels.attention_qkv(qkv, heads, head_dim, scale,
                                 logit_bias=logit_bias)


def ln_qkv_reference(x, ln_params, wq, bias, act_scale, eps=1e-6):
    """Plain PyTorch twin of K5 on any device, the JAX package's reference
    form: (..., W) → (..., N) in x's dtype."""
    a = f32_scalar(act_scale, x.device)
    w = x.shape[-1]
    q = quant_rows(ln_rows_f32(x.reshape(-1, w), ln_params["scale"],
                               ln_params["bias"], eps), a)
    acc = int8_mm(q, wq["q"])
    out = acc.float() * ((a / 127.0) * wq["scale"].float()) + bias.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], -1)


def _out_proj_reference(o, x, wq, bias, act_scale):
    """quant(o) · Wout dequantised + bias + residual x, in x's dtype."""
    a = f32_scalar(act_scale, o.device)
    b, s, wa = o.shape
    q8 = quant_rows(o.float(), a)
    acc = int8_mm(q8.reshape(b * s, wa), wq["q"]).reshape(b, s, -1)
    proj = acc.float() * ((a / 127.0) * wq["scale"].float()) + bias.float()
    return (x.float() + proj).to(x.dtype)


def attn_out_reference(qkv, x, wq, bias, act_scale, heads, head_dim,
                       scale=None, *, logit_bias=None):
    """Plain PyTorch twin of K6 and of its reference route on any device,
    the JAX package's reference form: it quantises the attention output
    rounded to qkv's dtype. On the reference route (`attn_out_int8_fits`
    false) without a bias, TPUDF_INT8_ATTN=1 takes 9b's twin."""
    scale = scale if scale is not None else head_dim ** -0.5
    if attn_out_int8_fits(qkv.shape[1], qkv.shape[2] // 3, x.shape[-1],
                          head_dim):
        o = attention_qkv_reference(qkv, heads, head_dim, scale, logit_bias)
    else:
        from tpudf_torch.ops.routes import TWINS   # routes imports this
        o = _route_attention(qkv, heads, head_dim, scale, logit_bias, TWINS)
    return _out_proj_reference(o, x, wq, bias, act_scale)


def attn_sublayer_reference(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                            a_qkv, a_out, heads, head_dim, eps=1e-6,
                            scale=None, *, logit_bias=None, live=None):
    """Plain PyTorch twin of K1 on any device: K5's twin, the bf16
    attention (K1's, whatever TPUDF_INT8_ATTN says), the out-projection
    of K6's twin. live: the kernel's argument; the twin reads every
    column of the heads."""
    scale = scale if scale is not None else head_dim ** -0.5
    qkv = ln_qkv_reference(x, ln_params, qkv_wq, qkv_b, a_qkv, eps)
    o = attention_qkv_reference(qkv, heads, head_dim, scale, logit_bias)
    return _out_proj_reference(o, x, out_wq, out_b, a_out)


def _f32(t):
    return None if t is None else t.float().contiguous()


GEMM_BF16, GEMM_GELU_I8, GEMM_RESIDUAL, GEMM_I32 = 0, 1, 2, 3
GEMM_RES_F32_OUT, GEMM_F32_RESIDUAL = 4, 5     # K7's split form


def check_i8_gemm(k, wt):
    """Raise unless the int8 GEMM takes K = k against the (N, K) weight
    wt: N % 128 == 0 and K % 64 == 0."""
    n = wt.shape[0]
    if wt.shape[1] != k or n % 128 or k % 64:
        raise ValueError(f"i8 GEMM needs N % 128 == 0 and K % 64 == 0, got "
                         f"N={n} K={k} (weight {tuple(wt.shape)})")


def i8_gemm_cuda(a8, wt, col_scale, bias, act, mode, *, residual=None,
                 sumsq=None, act_out=None):
    """out[m, n] = epilogue(Σ_k a8[m, k]·wt[n, k]) on the card.

    mode GEMM_BF16: bf16(acc·(act/127)·col_scale + bias);
    GEMM_GELU_I8: int8 quant with act_out of gelu_tanh of that;
    GEMM_RESIDUAL: bf16(residual + that), and Σ out² per row into sumsq
    (f32 atomics across column tiles) when sumsq is given; GEMM_I32: acc
    (col_scale, bias and act unused); GEMM_RES_F32_OUT: f32((residual +
    acc·cs) + bias) of a bf16 residual; GEMM_F32_RESIDUAL: bf16(residual +
    that) of an f32 residual."""
    m, k = a8.shape
    n = wt.shape[0]
    check_i8_gemm(k, wt)
    dt = {GEMM_GELU_I8: torch.int8, GEMM_I32: torch.int32,
          GEMM_RES_F32_OUT: torch.float32}.get(mode, torch.bfloat16)
    out = torch.empty((m, n), dtype=dt, device=a8.device)
    _build.call("tpudf_i8_gemm", a8, wt, _f32(col_scale), _f32(bias),
                _f32(act), residual, out, sumsq,
                None if act_out is None else _f32(act_out), m, n, k, mode)
    return out


def attention_i8_reference(qkv, heads, head_dim, act_out, scale=None, *,
                           logit_bias=None):
    """Plain twin of K1's attention launch: (B, S, 3Wa) → (B·S, Wa) int8
    codes of the f32 attention output with activation scale act_out."""
    scale = scale if scale is not None else head_dim ** -0.5
    b, s, _ = qkv.shape
    o = attention_qkv_reference(qkv, heads, head_dim, scale, logit_bias,
                                out_dtype=torch.float32)
    return quant_rows(o, f32_scalar(act_out, qkv.device)).reshape(b * s, -1)


def _attention_i8_cuda(qkv, heads, head_dim, scale, act_out, logit_bias,
                       live, out=None, exact=False):
    """One launch of K1's attention kernel (`tpudf_attention_i8_sm90`):
    qkv (B, S, 3 heads head_dim) bf16 → (B·S, heads head_dim) int8 codes,
    into `out` where given; exact: K9's softmax sequence (expf and the
    division; K7's) in place of K1's."""
    b, s, _ = qkv.shape
    width, hs = i8_attn_tile(head_dim, live)
    if hs != head_dim:          # zero columns: nothing added to q·k or p·v
        qkv = pad_heads(qkv, heads, head_dim, hs)
    o8 = out if out is not None else torch.empty(
        (b * s, heads * hs), dtype=torch.int8, device=qkv.device)
    bias = None
    if logit_bias is not None:
        # rows of whole 64-key tiles: each TMA box of the bias starts on a
        # 16-byte boundary
        bias = torch.nn.functional.pad(logit_bias.float(),
                                       (0, -s % SM90_TILE_ROWS)).contiguous()
    _build.call("tpudf_attention_i8_sm90", qkv.contiguous(), bias,
                f32_scalar(act_out, qkv.device), o8, b, s, heads, hs, width,
                float(scale), int(exact))
    return o8 if hs == head_dim else unpad_heads(o8, heads, head_dim,
                                                 hs).contiguous()


def attention_i8(qkv, heads, head_dim, act_out, scale=None, *,
                 logit_bias=None, live=None, out=None):
    """K1's attention launch alone: qkv (B, S, 3Wa) bf16 and an optional
    (B, S) f32 key bias → (B·S, Wa) int8 codes clip(round(o · 127 /
    act_out), ±127) of the f32 attention output o, the input of K1's
    out-projection. live: as `i8_attn_tile`; out: a (B·S, Wa) int8 buffer
    to write (where no head is padded). CPU tensors take the plain twin;
    CUDA tensors launch the kernel or raise."""
    scale = scale if scale is not None else head_dim ** -0.5
    i8_attn_tile(head_dim, live)
    if not qkv.is_cuda:
        return attention_i8_reference(qkv, heads, head_dim, act_out, scale,
                                      logit_bias=logit_bias)
    check_attention_shape("K1", qkv, heads, head_dim)
    return _attention_i8_cuda(qkv, heads, head_dim, scale, act_out,
                              logit_bias, live, out)


def check_attn_sublayer_int8(x, qkv_wq, out_wq, heads, head_dim, live=None):
    """Raise unless K1 takes this layer: bf16 x (B, S, W) of width 64k <=
    MAX_WIDTH, head_dim in HEAD_DIMS, `live` fitting the head
    (`i8_attn_tile`), S <= MAX_SEQ, B·S <= MAX_ROWS, a (W, 3 heads
    head_dim) QKV weight, and both int8 GEMMs' shapes (`check_i8_gemm`)."""
    b, s, w = x.shape
    wa = heads * head_dim
    wt = transposed(qkv_wq)
    i8_attn_tile(head_dim, live)
    if (x.dtype != torch.bfloat16 or head_dim not in HEAD_DIMS
            or s > MAX_SEQ or b * s > MAX_ROWS or w % 64 or w > MAX_WIDTH
            or tuple(wt.shape) != (3 * wa, w)):
        raise ValueError(f"K1 takes bf16 x of width 64k <= {MAX_WIDTH}, "
                         f"head_dim in {HEAD_DIMS}, S <= {MAX_SEQ} and a "
                         f"(W, 3 heads head_dim) weight, got {x.dtype} "
                         f"{tuple(x.shape)} head_dim {head_dim} weight "
                         f"{tuple(wt.t().shape)}")
    check_i8_gemm(w, wt)
    check_i8_gemm(wa, transposed(out_wq))


def _attn_sublayer_cuda(x, ln_params, qkv_wq, qkv_b, out_wq, out_b, a_qkv,
                        a_out, heads, head_dim, eps, scale, logit_bias, live):
    check_attn_sublayer_int8(x, qkv_wq, out_wq, heads, head_dim, live)
    b, s, w = x.shape
    wa = heads * head_dim
    wt = transposed(qkv_wq)
    x2d = x.reshape(b * s, w).contiguous()
    h8 = ln_quant_cuda(x2d, ln_params, a_qkv, eps)
    qkv = i8_gemm_cuda(h8, wt, qkv_wq["scale"], qkv_b, a_qkv, GEMM_BF16)
    o8 = _attention_i8_cuda(qkv.reshape(b, s, 3 * wa), heads, head_dim,
                            scale, a_out, logit_bias, live)
    out = i8_gemm_cuda(o8, transposed(out_wq), out_wq["scale"], out_b, a_out,
                       GEMM_RESIDUAL, residual=x2d)
    LAUNCHES.hit(KERNEL)
    return out.reshape(b, s, w)


def attn_sublayer_int8(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                       a_qkv, a_out, heads, head_dim, eps=1e-6,
                       scale=None, *, logit_bias=None, live=None):
    """(B, S, W) → (B, S, W): the attention sublayer. CPU tensors take the
    plain twin; CUDA tensors launch K1 or raise.

    qkv_wq/out_wq: {q: (in, out) int8, scale: (out,), optional qT}; a_qkv,
    a_out: 0-d f32 activation scales; logit_bias: optional (B, S) f32;
    live: the columns of each head that hold values, the rest exact zeros
    (so400m's 72 of 128, from the tower's config; None: all)."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not x.is_cuda:
        i8_attn_tile(head_dim, live)
        return attn_sublayer_reference(
            x, ln_params, qkv_wq, qkv_b, out_wq, out_b, a_qkv, a_out, heads,
            head_dim, eps, scale, logit_bias=logit_bias)
    return _attn_sublayer_cuda(x, ln_params, qkv_wq, qkv_b, out_wq, out_b,
                               a_qkv, a_out, heads, head_dim, eps, scale,
                               logit_bias, live)


# ------------------------------------------------------------------ K5

K5_TILE = 128           # csrc/int8_gemm_sm90.cu: kQM rows, kLnBN columns
K5_LN_COST = 3          # kLnCost: a panel's LN in column tiles' worth
H100_SMS = 132          # the persistent grid's blocks at most


def k5_splits(m, n, sms=H100_SMS):
    """The runs K5 cuts each row tile's n / 128 column tiles in
    (`ln_splits`): the s that minimises the waves of units (row tiles × s
    over `sms`) times a unit's work, its column tiles and K5_LN_COST for
    its panel; the smallest such s."""
    rows, tiles = -(-m // K5_TILE), n // K5_TILE
    best, best_cost = 1, None
    for s in range(1, tiles + 1):
        cost = -(-rows * s // sms) * (-(-tiles // s) + K5_LN_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def k5_units(m, n, sms=H100_SMS):
    """K5's persistent walk: per block, its units in order as (row tile,
    first column tile, end column tile); block b takes units b, b + grid,
    ... of row tile u // s and run u % s (s = `k5_splits`), and builds its
    panel at each."""
    s, tiles = k5_splits(m, n, sms), n // K5_TILE
    units = -(-m // K5_TILE) * s
    grid = min(units, sms)
    return [[(u // s, (u % s) * tiles // s, (u % s + 1) * tiles // s)
             for u in range(b, units, grid)] for b in range(grid)]


def k5_stages(w):
    """K5's weight stages at width w (`ln_stages`): what 227 KB holds
    beside the panel (ceil(w / 128) slices of 16 KB), the barriers and the
    alignment, at most 8."""
    room = 232448 - -(-w // 128) * 16384 - 1024 - 8 * 2
    return min(8, room // (128 * 128 + 16))


def _ln_qkv_cuda(x2d, ln_params, wq, bias, act_scale, eps, out=None):
    """K5 on (M, W) bf16 rows, uncounted: ONE launch where W <=
    K5_MAX_WIDTH, else K8's row pass then the int8 GEMM (GEMM_BF16), the
    same codes and the same epilogue; returns (out, whether split)."""
    m, w = x2d.shape
    wt = transposed(wq)
    n = wt.shape[0]
    if (x2d.dtype != torch.bfloat16 or w % 64 or w > MAX_WIDTH or n % 128
            or wt.shape[1] != w):
        raise ValueError(f"K5 takes bf16 x of width 64k <= {MAX_WIDTH} and "
                         f"N % 128 == 0, got {x2d.dtype} W={w} weight "
                         f"{tuple(wt.shape)}")
    if out is None:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x2d.device)
    elif out.shape != (m, n) or out.dtype != torch.bfloat16:
        raise ValueError(f"K5 writes a ({m}, {n}) bf16 out, got {out.dtype} "
                         f"{tuple(out.shape)}")
    if w > K5_MAX_WIDTH:
        h8 = ln_quant_cuda(x2d, ln_params, act_scale, eps)
        _build.call("tpudf_i8_gemm", h8, wt, _f32(wq["scale"]), _f32(bias),
                    f32_scalar(act_scale, x2d.device), None, out, None, None,
                    m, n, w, GEMM_BF16)
        return out, True
    _build.call("tpudf_ln_qkv_i8", x2d, _f32(ln_params["scale"]),
                _f32(ln_params["bias"]), wt, _f32(wq["scale"]), _f32(bias),
                f32_scalar(act_scale, x2d.device), out, m, n, w, float(eps))
    return out, False


def ln_qkv_int8(x, ln_params, wq, bias, act_scale, eps=1e-6, *, out=None):
    """(..., W) → (..., N): fused LN + static quant + int8 QKV projection.
    wq: {q: (W, N) int8, scale: (N,), optional qT}. CPU tensors take the
    plain twin; CUDA tensors launch K5 (bf16, W % 64 == 0, N % 128 == 0;
    past K5_MAX_WIDTH as K8 + the int8 GEMM, KERNEL_LN_QKV_SPLIT) or
    raise. out: a (rows, N) bf16 buffer to write."""
    if not x.is_cuda:
        return ln_qkv_reference(x, ln_params, wq, bias, act_scale, eps)
    lead, w = x.shape[:-1], x.shape[-1]
    got, split = _ln_qkv_cuda(x.reshape(-1, w).contiguous(), ln_params, wq,
                              bias, act_scale, eps, out)
    LAUNCHES.hit(KERNEL_LN_QKV_SPLIT if split else KERNEL_LN_QKV)
    return got.reshape(*lead, -1)


# ------------------------------------------------------------------ K6

def _attn_out_route_cuda(qkv, x, wq, bias, a, heads, head_dim, scale,
                         logit_bias):
    """JAX's reference route on the card: K9 (with the bias) or 9b, then
    the int8 out-projection GEMM with the residual epilogue."""
    from tpudf_torch.ops.routes import KERNELS     # routes imports this
    b, s, w = x.shape
    o = _route_attention(qkv, heads, head_dim, scale, logit_bias, KERNELS)
    o8 = quant_rows(o.float(), a).reshape(b * s, -1)
    out = i8_gemm_cuda(o8, transposed(wq), wq["scale"], bias, a,
                       GEMM_RESIDUAL,
                       residual=x.reshape(b * s, w).contiguous())
    LAUNCHES.hit(KERNEL_GEMM)
    return out.reshape(b, s, w)


def k6_route(s, heads, head_dim, w, logit_bias=False):
    """Which form of `attn_out_int8` runs on the card, from the shapes:
    "reference" where JAX takes its reference route (a logit bias, or
    `attn_out_int8_fits` false), else "K6" where the o panel fits K6's
    block (heads · k6_head_dim within K6_MAX_WA), else "split" (K1's
    attention launch + the int8 GEMM, the same function bit for bit)."""
    wa = heads * head_dim
    if logit_bias or not attn_out_int8_fits(s, wa, w, head_dim):
        return "reference"
    hk = k6_head_dim(head_dim)
    limit = K6_MAX_WA.get(hk)
    return "K6" if limit is not None and heads * hk <= limit else "split"


def check_attn_out_int8(qkv, x, wq, heads, head_dim):
    """Raise unless `attn_out_int8` takes this call on the card: qkv under
    `check_attention_shape`, bf16 x (B, S, W % 128 == 0) and a (Wa, W)
    out-projection (any Wa: past K6's panel the split form runs)."""
    b, s, _ = qkv.shape
    w = x.shape[-1]
    wa = heads * head_dim
    check_attention_shape("K6", qkv, heads, head_dim)
    if (x.dtype != torch.bfloat16 or w % 128
            or tuple(wq["q"].shape) != (wa, w) or x.shape != (b, s, w)):
        raise ValueError(f"K6 takes x (B, S, W % 128 == 0) bf16 and a (Wa, "
                         f"W) out-projection, got {x.dtype} "
                         f"{tuple(x.shape)}, weight "
                         f"{tuple(wq['q'].shape)}, head_dim {head_dim}")


def _attn_out_split_cuda(qkv, x, wq, bias, a, heads, head_dim, scale):
    """K6 as two launches (the wide heads, and Wa past K6's panel): K1's
    attention kernel writes the int8 codes of o, then the int8
    out-projection GEMM with the residual epilogue."""
    b, s, w = x.shape
    o8 = _attention_i8_cuda(qkv, heads, head_dim, scale, a, None, None)
    out = i8_gemm_cuda(o8, transposed(wq), wq["scale"], bias, a,
                       GEMM_RESIDUAL,
                       residual=x.reshape(b * s, w).contiguous())
    LAUNCHES.hit(KERNEL_ATTN_OUT_SPLIT)
    return out.reshape(b, s, w)


def attn_out_int8(qkv, x, wq, bias, act_scale, heads, head_dim, scale=None,
                  *, logit_bias=None):
    """qkv (B, S, 3Wa) + residual x (B, S, W) → (B, S, W): attention, int8
    quant, int8 out-projection, dequant + bias + residual. CPU tensors take
    the plain twin; CUDA tensors launch K6 (bf16, head_dim in HEAD_DIMS,
    narrower than 16 padded to 16, S <= MAX_SEQ, W % 128 == 0, Wa within
    K6_MAX_WA: its shared memory), or past that and at the wide heads its
    two launches, or raise; with a logit bias or where
    `attn_out_int8_fits` is false, K9 or 9b and the out-projection GEMM
    (`k6_route`). Heads of 16 and 32 run the attention zero-padded to 64
    (K1's tile), narrower ones are padded to 16 first (`k6_tile`)."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not qkv.is_cuda:
        return attn_out_reference(qkv, x, wq, bias, act_scale, heads,
                                  head_dim, scale, logit_bias=logit_bias)
    a = f32_scalar(act_scale, qkv.device)
    b, s, _ = qkv.shape
    w = x.shape[-1]
    route = k6_route(s, heads, head_dim, w, logit_bias is not None)
    if route == "reference":
        return _attn_out_route_cuda(qkv, x, wq, bias, a, heads, head_dim,
                                    scale, logit_bias)
    check_attn_out_int8(qkv, x, wq, heads, head_dim)
    if route == "split":
        return _attn_out_split_cuda(qkv.contiguous(), x, wq, bias, a, heads,
                                    head_dim, scale)
    tile, live = k6_tile(head_dim)
    wt = transposed(wq)
    if live != head_dim:        # zero weight columns: nothing added
        wt = pad_heads(wt, heads, head_dim, live).contiguous()
    if tile != head_dim:        # zero q, k, v columns: nothing added
        qkv = pad_heads(qkv, heads, head_dim, tile)
    out = torch.empty((b * s, w), dtype=torch.bfloat16, device=x.device)
    _build.call("tpudf_attn_out_i8", qkv.contiguous(),
                x.reshape(b * s, w).contiguous(), wt, _f32(wq["scale"]),
                _f32(bias), a, out, b, s, heads, tile, live, w, float(scale))
    LAUNCHES.hit(KERNEL_ATTN_OUT)
    return out.reshape(b, s, w)


# ------------------------------------------------------------------ K7

def k7_smem(w, wa, tile):
    """K7's dynamic shared memory a block (csrc/layer_int8.cu
    `layer_layout`): the panel (ceil(max(W, Wa) / 128) slices of 16 KB),
    the Q buffer (128 x tile bf16), as many ring stages (a 16 KB weight box
    or a K and a V tile, whichever is larger) as fit up to 8, the barriers
    of those and of fc2's ring (32 KB stages over the rest, up to 8) and
    the alignment; None where the ring holds fewer than two stages (its
    LN phases retire a stage while they wait for the next) or the tile is
    not 64 or 128 (heads of 256: a 64 KB Q buffer and 64 KB stages)."""
    ring = -(-max(w, wa) // 128) * 16384 + 128 * tile * 2
    stage = max(16384, 2 * 64 * tile * 2)
    room = SM90_BLOCK_SMEM - 1024 - 512 - ring
    stages = min(room // stage, 8) if room >= 0 else 0
    if stages < 2 or tile not in (64, 128):
        return None
    bars = ring + stages * stage
    return bars + 8 * (2 + 2 * stages + 2 * min(bars // 32768, 8)) + 1024


def k7_form(s, w, heads, head_dim):
    """Which form of K7 runs a layer that JAX's K7 takes: "one" (the
    one-launch kernel: a head of at most 128 on K6's tile, its o panel
    within K6_MAX_WA, two ring stages beside it (`k7_smem`), W <=
    K5_MAX_WIDTH) or "split" (its arithmetic in separate launches: heads
    of 256 and the wide heads, Wa past K6's panel, W past the LN panel)."""
    hk = k6_head_dim(head_dim)
    limit = K6_MAX_WA.get(hk)
    tile, live = k6_tile(head_dim)
    if (limit is None or heads * hk > limit or w > K5_MAX_WIDTH
            or k7_smem(w, heads * live, tile) is None):
        return "split"
    return "one"


def k7_launch(b, s, heads, w, inter, waves=None, head_dim=64):
    """K7's launch (csrc/layer_int8.cu `launch_layer`): (C, blocks, runs1,
    runs3): its attention phase's cluster size by K6's rule (`k6_cluster`
    on K6's tile of the head), as many clusters of C as the card holds
    (waves[C]; H100_CLUSTERS by default) for the cooperative grid, and the
    runs its LN phases cut a row tile's column tiles in over those blocks
    (`k5_splits`: phase 1 into 3 heads tile columns, phase 3 into the
    MLP's)."""
    waves = waves or H100_CLUSTERS
    tile, live = k6_tile(head_dim)
    c = k6_cluster(b, s, heads, tile, live, w, waves)
    blocks = waves[c] * c
    return c, blocks, k5_splits(b * s, 3 * heads * tile, blocks), k5_splits(
        b * s, inter, blocks)


def _layer_structure_ok(x, bp, heads, head_dim):
    """JAX's structural conditions for its whole-layer kernel
    (tpudf/ops/int8_block.py:337-345): lane-aligned heads, W, S and the MLP
    aligned, head slots not padded."""
    _, s, w = x.shape
    attn = bp["attn"]
    inter = bp["mlp"]["fc1_w"]["q"].shape[-1]
    return (_lane_ok(head_dim) and w % 128 == 0 and s % 8 == 0
            and inter % 128 == 0 and heads * head_dim == w
            and tuple(attn["qkv_w"]["q"].shape) == (w, 3 * w)
            and tuple(attn["out_w"]["q"].shape) == (w, w))


def layer_int8_fits(s, w, inter):
    """JAX's VMEM estimate for its whole-layer kernel
    (tpudf/ops/int8_block.py:346-348, formula copied): the int8 weights
    and the activations of one image within 13 MB (base-256 at S = 256
    needs 14.0 MB)."""
    weights = 4 * w * w + 2 * w * inter
    acts = s * 3 * w * 2 + s * s * 4 + s * inter * 4 + 3 * s * w * 4
    return weights + acts <= 13 * MiB


def layer_int8_eligible(x, bp, heads, head_dim, logit_bias=None):
    """JAX's decision for its whole-layer kernel, and its dispatcher's (no
    logit bias): `_layer_structure_ok` and `layer_int8_fits`. Where it
    holds the LLL block runs K7, otherwise FPP, as on a TPU."""
    _, s, w = x.shape
    return (logit_bias is None and _layer_structure_ok(x, bp, heads, head_dim)
            and layer_int8_fits(s, w, bp["mlp"]["fc1_w"]["q"].shape[-1]))


def _scales(bp, device):
    sc = bp["act_scales"]
    return [f32_scalar(sc[k], device) for k in ("qkv", "out", "fc1", "fc2")]


def siglip_layer_int8_reference(x, bp, heads, head_dim, eps=1e-6,
                                scale=None):
    """Plain PyTorch twin of K7, from `_layer_kernel`'s math: qkv rounded
    to bf16 (at any x dtype), the attention output quantised from f32, the
    attention sublayer's residual kept f32 into LN2 and the final add
    ((x + acc·s) + b, the TPU kernel's order), one cast at the end."""
    b, s, w = x.shape
    scale = scale if scale is not None else head_dim ** -0.5
    attn, mlp = bp["attn"], bp["mlp"]
    aq, ao, a1, a2 = _scales(bp, x.device)

    def deq(acc, a, wq):
        return acc.float() * ((a / 127.0) * wq["scale"].float())

    x32 = x.float().reshape(b * s, w)
    q8 = quant_rows(ln_rows_f32(x32, bp["ln1"]["scale"], bp["ln1"]["bias"],
                                eps), aq)
    qkv = (deq(int8_mm(q8, attn["qkv_w"]["q"]), aq, attn["qkv_w"])
           + attn["qkv_b"].float()).to(torch.bfloat16).reshape(b, s, 3 * w)
    o = attention_qkv_reference(qkv, heads, head_dim, scale,
                                out_dtype=torch.float32)
    o8 = quant_rows(o.reshape(b * s, w), ao)
    x32 = (x32 + deq(int8_mm(o8, attn["out_w"]["q"]), ao, attn["out_w"])
           + attn["out_b"].float())
    q1 = quant_rows(ln_rows_f32(x32, bp["ln2"]["scale"], bp["ln2"]["bias"],
                                eps), a1)
    h1 = gelu_tanh(deq(int8_mm(q1, mlp["fc1_w"]["q"]), a1, mlp["fc1_w"])
                   + mlp["fc1_b"].float())
    q2 = quant_rows(h1, a2)
    out = (deq(int8_mm(q2, mlp["fc2_w"]["q"]), a2, mlp["fc2_w"])
           + mlp["fc2_b"].float())
    return (x32 + out).to(x.dtype).reshape(b, s, w)


def _check_layer(x, bp, heads, head_dim):
    """Raise unless K7 (one launch or split) takes this layer: bf16 x
    within the attention's S and row limits and JAX's structural
    conditions (not its VMEM fit: the kernels run past it; the dispatcher
    routes by `layer_int8_eligible`)."""
    b, s, w = x.shape
    if (x.dtype != torch.bfloat16 or head_dim not in HEAD_DIMS
            or s > MAX_SEQ or b * s > MAX_ROWS or w > MAX_WIDTH
            or not _layer_structure_ok(x, bp, heads, head_dim)):
        raise ValueError(f"K7 takes bf16 x with lane-aligned unpadded "
                         f"heads, W, S and the MLP aligned, got {x.dtype} "
                         f"{tuple(x.shape)} heads {heads} head_dim "
                         f"{head_dim} MLP "
                         f"{bp['mlp']['fc1_w']['q'].shape[-1]}")


def _layer_cuda(x, bp, heads, head_dim, eps, scale):
    """The one-launch K7: the QKV weight's heads zero-padded to K6's tile
    (zero rows, scales and biases: exact zero q, k, v columns) and the
    out-projection's to its panel width (zero columns add nothing)."""
    b, s, w = x.shape
    attn, mlp = bp["attn"], bp["mlp"]
    inter = mlp["fc1_w"]["q"].shape[-1]
    tile, live = k6_tile(head_dim)
    wqkv, sqkv, bqkv = (transposed(attn["qkv_w"]), _f32(attn["qkv_w"]["scale"]),
                        _f32(attn["qkv_b"]))
    wout = transposed(attn["out_w"])
    if tile != head_dim:
        wqkv = pad_heads(wqkv.t(), heads, head_dim, tile).t().contiguous()
        sqkv, bqkv = (pad_heads(v, heads, head_dim, tile).contiguous()
                      for v in (sqkv, bqkv))
    if live != head_dim:
        wout = pad_heads(wout, heads, head_dim, live).contiguous()
    m, dev = b * s, x.device
    qkv_ws = torch.empty((m, 3 * heads * tile), dtype=torch.bfloat16,
                         device=dev)
    x1_ws = torch.empty((m, w), dtype=torch.float32, device=dev)
    hid_ws = torch.empty((m, inter), dtype=torch.int8, device=dev)
    out = torch.empty((m, w), dtype=torch.bfloat16, device=dev)
    acts = torch.stack(_scales(bp, dev))
    _build.call(
        "tpudf_layer_i8", x.reshape(m, w).contiguous(),
        _f32(bp["ln1"]["scale"]), _f32(bp["ln1"]["bias"]), wqkv, sqkv, bqkv,
        wout, _f32(attn["out_w"]["scale"]), _f32(attn["out_b"]),
        _f32(bp["ln2"]["scale"]), _f32(bp["ln2"]["bias"]),
        transposed(mlp["fc1_w"]), _f32(mlp["fc1_w"]["scale"]),
        _f32(mlp["fc1_b"]), transposed(mlp["fc2_w"]),
        _f32(mlp["fc2_w"]["scale"]), _f32(mlp["fc2_b"]), acts, qkv_ws,
        x1_ws, hid_ws, out, b, s, heads, w, inter, tile, live, float(eps),
        float(scale))
    LAUNCHES.hit(KERNEL_LAYER)
    return out.reshape(b, s, w)


def _layer_split_cuda(x, bp, heads, head_dim, eps, scale):
    """K7's split form, `siglip_layer_int8_reference`'s arithmetic in
    separate launches: LN1 + QKV by K5 (K8 + the GEMM past its panel), qkv
    rounded to bf16; the attention with K9's exact softmax into the int8
    codes of the f32 o; the out-projection into the f32 x1 = (x + acc·cs)
    + b (GEMM_RES_F32_OUT); LN2 over those f32 rows into codes; fc1 + GELU
    into codes; fc2 with the f32 x1 as its residual, cast to bf16 once."""
    b, s, w = x.shape
    attn, mlp = bp["attn"], bp["mlp"]
    aq, ao, a1, a2 = _scales(bp, x.device)
    x2d = x.reshape(b * s, w).contiguous()
    qkv, _ = _ln_qkv_cuda(x2d, bp["ln1"], attn["qkv_w"], attn["qkv_b"], aq,
                          eps)
    o8 = _attention_i8_cuda(qkv.reshape(b, s, 3 * w), heads, head_dim, scale,
                            ao, None, None, exact=True)
    x1 = i8_gemm_cuda(o8, transposed(attn["out_w"]), attn["out_w"]["scale"],
                      attn["out_b"], ao, GEMM_RES_F32_OUT, residual=x2d)
    h8 = ln_quant_f32_cuda(x1, bp["ln2"], a1, eps)
    hid = i8_gemm_cuda(h8, transposed(mlp["fc1_w"]), mlp["fc1_w"]["scale"],
                       mlp["fc1_b"], a1, GEMM_GELU_I8, act_out=a2)
    out = i8_gemm_cuda(hid, transposed(mlp["fc2_w"]), mlp["fc2_w"]["scale"],
                       mlp["fc2_b"], a2, GEMM_F32_RESIDUAL, residual=x1)
    LAUNCHES.hit(KERNEL_LAYER_SPLIT)
    return out.reshape(b, s, w)


def siglip_layer_int8(x, bp, heads, head_dim, eps=1e-6, scale=None):
    """(B, S, W) → (B, S, W): one static-W8A8 layer. bp: the layer's
    quantize_siglip_static slice with act_scales. CPU tensors take the
    plain twin; CUDA tensors run K7 (one launch or its split form,
    `k7_form`) within JAX's structural conditions, or raise. The LLL
    dispatcher calls it only where JAX's whole decision holds
    (`layer_int8_eligible`) and routes the other layers FPP."""
    scale = scale if scale is not None else head_dim ** -0.5
    if not x.is_cuda:
        return siglip_layer_int8_reference(x, bp, heads, head_dim, eps, scale)
    _check_layer(x, bp, heads, head_dim)
    if k7_form(x.shape[1], x.shape[2], heads, head_dim) == "one":
        return _layer_cuda(x, bp, heads, head_dim, eps, scale)
    return _layer_split_cuda(x, bp, heads, head_dim, eps, scale)
