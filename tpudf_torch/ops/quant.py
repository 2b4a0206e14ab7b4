"""Static W8A8 quantization of the SigLIP tower (tpudf/ops/quant.py).

Weights: symmetric per-output-column int8, `{q: (in, out) int8, scale:
(out,) f32}`. Activations: one calibrated per-tensor scale per projection
and layer, stored under `blocks["act_scales"]`. Calibration is set-up: it
runs the float tower once in plain torch products, as the JAX package does;
its layer norms go through kernel K4 on the card, as the JAX tower sends
them to the Pallas LN on a TPU.

`quant_rows` and `int8_mm` are the plain int8 arithmetic that the kernels'
twins share. `int8_mm` is exact: it multiplies in f32 over K-chunks of at
most 1024, where every partial sum is an integer below 2^24, and adds the
chunks in int32.

`quantize_activation`, `int8_matmul` (dynamic per-row scales),
`int8_matmul_static` and `int8_matmul_pre` are the JAX package's XLA
products (no Pallas kernel): the dynamic-int8 block and the X routes of
the static block use them. Their quantisation and dequantisation are
plain torch in the JAX order and dtypes; the exact int32 product `acc` is
`int8_acc`: `int8_mm` on a CPU tensor, the port's int8 GEMM
(`csrc/int8_gemm_sm90.cu`, int32 output) on a CUDA tensor. `int8_acc_reference`
is the product without a kernel on any device (`routes.TWINS`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.core.precision import DEFAULT_POLICY, cast_tree
from tpudf_torch.ops import _build
from tpudf_torch.ops.attention import attention_qkv_reference

_EXACT_K = 1024          # 1024 * 127 * 127 < 2**24
_CALIB_SCORE_BYTES = 512 * 2**20   # f32 scores of one calibration chunk
KERNEL_GEMM = "int8_gemm"      # launches of the port's int8 GEMM
                            # outside K1, K2 and K5-K7
GEMM_I32 = 3             # csrc/gemm_i8.cuh kEpiI32


def quant_rows(y, a):
    """Static symmetric int8 codes of f32 y with activation scale a
    (round half to even, as jnp.round)."""
    return torch.clamp(torch.round(y * (127.0 / a)), -127, 127).to(torch.int8)


def int8_mm(a8, w8):
    """(M, K) int8 @ (K, N) int8 → (M, N) int32, exactly."""
    acc = None
    for k0 in range(0, a8.shape[-1], _EXACT_K):
        part = torch.matmul(a8[..., k0:k0 + _EXACT_K].float(),
                            w8[k0:k0 + _EXACT_K].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def transposed(wq):
    """(N, K) int8 layout the GEMM kernels read; derived once by
    tpudf_torch.convert.add_kernel_layout, else here."""
    qt = wq.get("qT")
    return qt if qt is not None else wq["q"].t().contiguous()


def int8_acc_reference(a8, wq):
    """(..., K) int8 codes . wq["q"] (K, N) → (..., N) int32, exactly."""
    return int8_mm(a8, wq["q"])


def check_int8_acc(a8, wq):
    """Raise unless the int8 GEMM takes a8 (..., K) int8 codes times wq's
    (K, N) int8 weight: N % 128 == 0 and K % 64 == 0."""
    k = a8.shape[-1]
    kw, n = wq["q"].shape
    if a8.dtype != torch.int8 or kw != k or n % 128 or k % 64:
        raise ValueError(f"the int8 GEMM takes int8 codes with N % 128 == 0 "
                         f"and K % 64 == 0, got {a8.dtype} K={k} weight "
                         f"{tuple(wq['q'].shape)}")


def int8_acc(a8, wq):
    """`int8_acc_reference` on a CPU tensor; on a CUDA tensor one launch of
    the port's int8 GEMM with an int32 output (`check_int8_acc`, or it
    raises)."""
    if not a8.is_cuda:
        return int8_acc_reference(a8, wq)
    check_int8_acc(a8, wq)
    lead, k = a8.shape[:-1], a8.shape[-1]
    wt = transposed(wq)
    n = wt.shape[0]
    a2 = a8.reshape(-1, k).contiguous()
    m = a2.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a8.device)
    _build.call("tpudf_i8_gemm", a2, wt, None, None, None, None, out, None,
                None, m, n, k, GEMM_I32)
    LAUNCHES.hit(KERNEL_GEMM)
    return out.reshape(*lead, n)


def f32_scalar(a, device):
    """An activation scale (0-d tensor or number) as a 0-d f32 tensor."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def quantize_activation(x):
    """(..., in) → (int8 codes, (..., 1) f32 row scales): dynamic
    symmetric per-row quantisation; the scale amax/127 is computed in x's
    dtype, as jnp does."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(x, wq, out_dtype=torch.bfloat16, *, acc=int8_acc):
    """x (..., in) float, wq {q, scale} → (..., out): dynamic per-row
    activation scales."""
    xq, xs = quantize_activation(x)
    return (acc(xq, wq).float() * xs * wq["scale"].float()).to(out_dtype)


def int8_matmul_static(x, wq, act_scale, out_dtype=None, *, acc=int8_acc):
    """W8A8 with a static per-tensor activation scale; out in x's dtype."""
    a = f32_scalar(act_scale, x.device)
    q = quant_rows(x.float(), a)
    return (acc(q, wq).float() * (a / 127.0) * wq["scale"].float()).to(
        out_dtype or x.dtype)


def int8_matmul_pre(q, wq, act_scale, out_dtype=torch.bfloat16, *,
                    acc=int8_acc):
    """Pre-quantised int8 codes (layernorm.layer_norm_quant) x int8
    weights → dequantised output, bf16 whatever the caller's dtype."""
    a = f32_scalar(act_scale, q.device)
    return (acc(q, wq).float() * (a / 127.0) * wq["scale"].float()).to(
        out_dtype)


def quantize_weight(w):
    """(in, out) f32 → {int8 (in,out), scale (out,)} symmetric per-column."""
    amax = torch.amax(torch.abs(w), dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _q_stacked(w):
    # w: (L, in, out) — per-layer, per-column scales
    amax = torch.amax(torch.abs(w), dim=1)                       # (L, out)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale.float()}


def quantize_siglip(params, cfg=None):
    """int8 inference tree: the stacked block projection weights become
    {q, scale}; everything else stays float. With cfg, also pre-pad for
    the kernels (`prepad_siglip_static`), once: the dynamic-int8 tower of
    a lane-misaligned geometry (so400m) then pads nothing per forward."""
    blocks = params["blocks"]
    out = dict(params)
    out["blocks"] = {
        "ln1": blocks["ln1"],
        "ln2": blocks["ln2"],
        "attn": {
            "qkv_w": _q_stacked(blocks["attn"]["qkv_w"]),
            "qkv_b": blocks["attn"]["qkv_b"],
            "out_w": _q_stacked(blocks["attn"]["out_w"]),
            "out_b": blocks["attn"]["out_b"],
        },
        "mlp": {
            "fc1_w": _q_stacked(blocks["mlp"]["fc1_w"]),
            "fc1_b": blocks["mlp"]["fc1_b"],
            "fc2_w": _q_stacked(blocks["mlp"]["fc2_w"]),
            "fc2_b": blocks["mlp"]["fc2_b"],
        },
    }
    return out if cfg is None else prepad_siglip_static(out, cfg)


def is_quantized(block_params) -> bool:
    w = block_params["attn"]["qkv_w"]
    return isinstance(w, dict) and "q" in w


def is_static_quantized(block_params) -> bool:
    return is_quantized(block_params) and "act_scales" in block_params


@torch.no_grad()
def calibrate_siglip_act_scales(params, cfg, pixels, policy=None):
    """Run the float tower over a calibration batch and record the abs-max
    of each projection's input per layer. Pixels of another size than the
    config's get the interpolated position embedding (`siglip.embed`), as
    in JAX's calibration.

    The twin attention materialises (B, H, S, S) f32 scores, so it runs in
    batch chunks of at most 512 MB of scores (so400m-512: 64 MB an image).

    Returns {"qkv": (L,), "out": (L,), "fc1": (L,), "fc2": (L,)} f32."""
    from tpudf_torch.models import siglip as S   # siglip imports this module

    policy = policy or DEFAULT_POLICY
    cdt = policy.compute_dtype
    x = S.embed(params["embed"], pixels.to(cdt), cfg)

    scales = {"qkv": [], "out": [], "fc1": [], "fc2": []}

    def amax(t):
        return torch.clamp(torch.amax(torch.abs(t.float())), min=1e-3)

    n = x.shape[1]
    chunk = max(1, _CALIB_SCORE_BYTES // (cfg.heads * n * n * 4))

    for i in range(cfg.layers):
        bp = cast_tree(S.layer_slice(params["blocks"], i), cdt)
        h1 = S.layer_norm(x, bp["ln1"], cfg.ln_eps)
        scales["qkv"].append(amax(h1))
        qkv = h1 @ bp["attn"]["qkv_w"] + bp["attn"]["qkv_b"]
        o = torch.cat([attention_qkv_reference(c, cfg.heads, cfg.head_dim)
                       for c in torch.split(qkv, chunk)])
        scales["out"].append(amax(o))
        x = x + (o @ bp["attn"]["out_w"] + bp["attn"]["out_b"])
        h2 = S.layer_norm(x, bp["ln2"], cfg.ln_eps)
        scales["fc1"].append(amax(h2))
        g = S.gelu_tanh(h2 @ bp["mlp"]["fc1_w"] + bp["mlp"]["fc1_b"])
        scales["fc2"].append(amax(g))
        x = x + (g @ bp["mlp"]["fc2_w"] + bp["mlp"]["fc2_b"])
    return {k: torch.stack(v).float() for k, v in scales.items()}


def quantize_siglip_static(params, act_scales, cfg=None):
    """quantize_siglip layout plus per-layer activation scales under
    blocks["act_scales"]; with cfg, also pre-pad for the kernels."""
    out = quantize_siglip(params)
    out["blocks"]["act_scales"] = {k: v.float()
                                   for k, v in act_scales.items()}
    if cfg is not None:
        out = prepad_siglip_static(out, cfg)
    return out


def prepad_siglip_static(params, cfg):
    """Zero-pad each head's slot to a 128 multiple (so400m head_dim 72 →
    128) and the MLP hidden dim to a 128 multiple (4304 → 4352) of a
    quantised tree, static or dynamic. Exact algebra; scales pad with 1.
    No-op for aligned geometries."""
    d, heads = cfg.head_dim, cfg.heads
    blocks = dict(params["blocks"])
    if not (d % 128 == 0 or 128 % d == 0):
        dp = ((d + 127) // 128) * 128
        attn = dict(blocks["attn"])
        qkv = attn["qkv_w"]
        nl, w_, n3 = qkv["q"].shape
        if n3 != 3 * heads * dp:
            attn["qkv_w"] = {
                "q": F.pad(qkv["q"].reshape(nl, w_, 3, heads, d),
                           (0, dp - d)).reshape(nl, w_, 3 * heads * dp),
                "scale": F.pad(qkv["scale"].reshape(nl, 3, heads, d),
                               (0, dp - d), value=1.0
                               ).reshape(nl, 3 * heads * dp),
            }
            attn["qkv_b"] = F.pad(attn["qkv_b"].reshape(nl, 3, heads, d),
                                  (0, dp - d)).reshape(nl, 3 * heads * dp)
            ow = attn["out_w"]
            attn["out_w"] = {
                "q": F.pad(ow["q"].reshape(nl, heads, d, w_),
                           (0, 0, 0, dp - d)).reshape(nl, heads * dp, w_),
                "scale": ow["scale"],
            }
            blocks["attn"] = attn
    inter = blocks["mlp"]["fc1_w"]["q"].shape[-1]
    if inter % 128:
        ip = ((inter + 127) // 128) * 128
        m = dict(blocks["mlp"])
        m["fc1_w"] = {"q": F.pad(m["fc1_w"]["q"], (0, ip - inter)),
                      "scale": F.pad(m["fc1_w"]["scale"], (0, ip - inter),
                                     value=1.0)}
        m["fc1_b"] = F.pad(m["fc1_b"], (0, ip - inter))
        m["fc2_w"] = {"q": F.pad(m["fc2_w"]["q"], (0, 0, 0, ip - inter)),
                      "scale": m["fc2_w"]["scale"]}
        blocks["mlp"] = m
    out = dict(params)
    out["blocks"] = blocks
    return out
