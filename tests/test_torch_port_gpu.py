"""Card-only tests: each CUDA kernel of tpudf_torch against its plain twin
on the card, at small shapes (K8's int8 codes within one step: a tie of
the f32 LN may round the other way), and at the large backbones' longer
sequences and wider heads (K1, K6, K9 and 9b at S = 576 / 1024 / 1296
and ragged past 1024, head_dim 64 / 128, the LN passes at width 1152), the
bf16 GEMM of K13, K14 and 15 in each epilogue mode at the edges of its
tiles and at a path shape, K9 and K10 at the edges of their tiles (S =
32, ragged S, heads of 128, the bias), kernels 11 and 12 (plain attention
in both layouts, ragged keys, Sq != Skv, heads of 72, bf16 and f32, and
the gradient through kernel 11), K1, K6, K9, 9b and K10 at heads of 16,
32, 256 and 384-1280 with planted faults, K1's attention launch alone at
the detect cores' first layers (so400m's on the 80-wide tile), the int8
GEMM of int8_gemm_sm90.cu in each mode at the edges of its tiles, K5 on
that GEMM with its LN panel (65536 rows, a ragged M, W = 832 and 1280,
with planted faults), 9b's pre-pass and int8 wgmma pass (heads of 64
and 128, S = 576 / 1024 / 1297, v8t's key order), K6's cluster tile
(bit-equal to K1's attention + the int8 GEMM, planted faults) and K7 on
the sm90 tiles (planted faults), K6 past its panel on its split route, K7
where JAX's decision runs it (one launch at heads of 16 to 128, its split
form at 384 and W 1408), rows past 1280 in the row pass and K5 past its
panel, K3 on its strips (each with planted faults that fail by at least
twice the tolerance), the
probes' kernels 15, 16 and 17 (the
tolerances of tests/test_torch_port_probes.py; 17 by 9b's card rule), both
serving engines, their image reports (kernels vs twins, the battery on
the card vs the CPU), their video reports (the same, by chip_smoke.py
phase 3v's rules) and one MTL train step against the same parameters
through the twins (the main path's shapes are checked by chip_smoke.py). Marked
`gpu`; each test skips inside its body when no card is visible, so every
worker collects the same tests. This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from tpudf_torch.ops import (attention, int8_block, layernorm, linear, mlp,
                             quant, srm)
from tpudf_torch.probes import micro_attn_static as p17
from tpudf_torch.probes import micro_epilogue as p16
from tpudf_torch.probes import micro_pallas_int8 as p15

W, HEADS, HD, INTER = 128, 2, 64, 256


def _int8_layer(r, ln):
    """A static-W8A8 layer's tree (quantize_siglip_static's slice)."""
    dev = ln["scale"].device
    q = lambda a, c: quant.quantize_weight(r(a, c, std=a ** -0.5))
    return {"ln1": ln, "ln2": {"scale": 1.0 + r(W, std=0.1),
                               "bias": r(W, std=0.1)},
            "attn": {"qkv_w": q(W, 3 * W), "qkv_b": r(3 * W, std=0.1),
                     "out_w": q(W, W), "out_b": r(W, std=0.1)},
            "mlp": {"fc1_w": q(W, INTER), "fc1_b": r(INTER, std=0.1),
                    "fc2_w": q(INTER, W), "fc2_b": r(W, std=0.1)},
            "act_scales": {k: torch.tensor(v, device=dev) for k, v in
                           (("qkv", 4.0), ("out", 2.0), ("fc1", 4.0),
                            ("fc2", 3.0))}}


def _card_case(name, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
    ln = {"scale": 1.0 + r(W, std=0.1), "bias": r(W, std=0.1)}
    if name == "K4":
        x = (r(300, W) * 3).to(torch.bfloat16)
        return (layernorm.layer_norm_fused(x, ln["scale"], ln["bias"]),
                layernorm.layer_norm_reference(x, ln["scale"], ln["bias"]),
                1e-6, 2 ** -7)
    if name == "K3":
        gray = torch.rand((3, 64, 128), generator=g, device=dev)
        return (srm.srm_raw_moments(gray),
                srm.srm_raw_moments_reference(gray), 1e-6, 1e-4)
    if name == "K1":
        wq = quant.quantize_weight(r(W, 3 * W, std=W ** -0.5))
        oq = quant.quantize_weight(r(W, W, std=W ** -0.5))
        x = r(4, 40, W).to(torch.bfloat16)
        lb = torch.log(torch.randint(1, 5, (4, 40), generator=g,
                                     device=dev).float())
        args = (x, ln, wq, r(3 * W, std=0.1), oq, r(W, std=0.1),
                torch.tensor(4.0, device=dev), torch.tensor(2.0, device=dev),
                HEADS, HD)
        return (int8_block.attn_sublayer_int8(*args, logit_bias=lb),
                int8_block.attn_sublayer_reference(*args, logit_bias=lb),
                5e-2, 2e-2)
    if name in ("K5", "K6", "K6-bias", "K7"):
        bp = _int8_layer(r, ln)
        a = bp["act_scales"]
        if name == "K5":
            x = r(3, 50, W).to(torch.bfloat16)
            args = (x, ln, bp["attn"]["qkv_w"], bp["attn"]["qkv_b"], a["qkv"])
            return (int8_block.ln_qkv_int8(*args),
                    int8_block.ln_qkv_reference(*args), 5e-2, 2e-2)
        if name == "K7":
            x = r(3, 40, W).to(torch.bfloat16)
            return (int8_block.siglip_layer_int8(x, bp, HEADS, HD),
                    int8_block.siglip_layer_int8_reference(x, bp, HEADS, HD),
                    5e-2, 2e-2)
        qkv = r(3, 200, 3 * W).to(torch.bfloat16)
        x = r(3, 200, W).to(torch.bfloat16)
        lb = (torch.log(torch.randint(1, 5, (3, 200), generator=g,
                                      device=dev).float())
              if name == "K6-bias" else None)
        args = (qkv, x, bp["attn"]["out_w"], bp["attn"]["out_b"], a["out"],
                HEADS, HD)
        return (int8_block.attn_out_int8(*args, logit_bias=lb),
                int8_block.attn_out_reference(*args, logit_bias=lb),
                5e-2, 2e-2)
    if name == "K8":
        # int8 codes: a rounding tie of the f32 LN may take the neighbour
        x = (r(300, W) * 3).to(torch.bfloat16)
        a = torch.tensor(3.0, device=dev)
        return (layernorm.layer_norm_quant(x, ln["scale"], ln["bias"], a),
                layernorm.layer_norm_quant_reference(x, ln["scale"],
                                                     ln["bias"], a),
                1.0, 0.0)
    if name == "K10":
        qkv = r(3, 200, 3 * W).to(torch.bfloat16)
        g_out = r(3, 200, W).to(torch.bfloat16)
        return (attention.attention_qkv_bwd(qkv, g_out, HEADS, HD),
                attention.attention_qkv_bwd_reference(qkv, g_out, HEADS, HD),
                1e-2, 2 ** -7)
    if name == "K9":
        qkv = r(3, 200, 3 * W).to(torch.bfloat16)
        lb = torch.log(torch.randint(1, 5, (3, 200), generator=g,
                                     device=dev).float())
        return (attention.attention_qkv(qkv, HEADS, HD, logit_bias=lb),
                attention.attention_qkv_reference(qkv, HEADS, HD,
                                                  logit_bias=lb),
                1e-2, 1e-2)
    bf = lambda *s, std=1.0: r(*s, std=std).to(torch.bfloat16)
    if name.startswith("K13"):
        x = bf(3, 50, W)
        w, b = bf(W, 3 * W, std=W ** -0.5), r(3 * W, std=0.1)
        kw = {"K13-ln": dict(ln=(ln["scale"], ln["bias"])),
              "K13-gelu": dict(activation="gelu"),
              "K13-res": dict(residual=bf(3, 50, 3 * W))}[name]
        return (linear.linear_fused(x, w, b, **kw),
                linear.linear_fused_reference(x, w, b, **kw), 1e-2, 1e-2)
    if name == "K14":
        mp = {"fc1_w": bf(W, INTER, std=W ** -0.5), "fc1_b": r(INTER, std=0.1),
              "fc2_w": bf(INTER, W, std=INTER ** -0.5), "fc2_b": r(W, std=0.1)}
        x = bf(3, 50, W)
        return (mlp.mlp_block_fused(x, ln, mp),
                mlp.mlp_block_reference(x, ln, mp), 1e-2, 1e-2)
    mq = {"fc1_w": quant.quantize_weight(r(W, INTER, std=W ** -0.5)),
          "fc1_b": r(INTER, std=0.1),
          "fc2_w": quant.quantize_weight(r(INTER, W, std=INTER ** -0.5)),
          "fc2_b": r(W, std=0.1)}
    sc = {"fc1": torch.tensor(4.0, device=dev),
          "fc2": torch.tensor(3.0, device=dev)}
    x = r(3, 50, W).to(torch.bfloat16)
    return (mlp.mlp_block_fused_int8(x, ln, mq, sc),
            mlp.mlp_block_int8_reference(x, ln, mq, sc), 5e-2, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5", "K6",
                                  "K6-bias", "K7", "K8", "K9", "K10",
                                  "K13-ln", "K13-gelu", "K13-res", "K14"])
def test_kernel_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got, ref, atol, rtol = _card_case(name, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _share_apart(a, b):
    """The share of elements of a and b more than one bf16 step apart."""
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return float(((a - b).abs() > step).float().mean())


def _large_case(name, dev):
    """(kernel output, twin output, atol, rtol, measure, limit, planted
    faults' outputs) at the large backbones' shapes: S = 576 with heads of
    64 (large-384), S = 1024 with heads of 72 zero-padded to 128 and scale
    72^-0.5 (so400m-512), and past 1024 with heads of 64 (S = 1296, a
    patch-16 tower at 576 px, and the ragged 1297, or 1304 where the
    kernel takes S % 8 == 0). q, k and v have std ~1.5 (scores of std ~2.25),
    so that the attention shows: K9 and 9b are held to at most 1e-2 of
    their outputs more than a bf16 step from the twin, K1 and K6 to
    |out - twin| <= 5e-2 |twin - x| (the attention sublayer's part; the
    twin quantises the bf16-rounded attention output), and each measure
    must exceed its limit for the kernel with the scale taken from the
    padded head_dim (at heads of 64 the same 0.75 ratio) and with the key
    bias dropped."""
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
    s_ = int(name.split("-")[1])
    hd, heads, scale = ((128, 1, 72 ** -0.5) if s_ == 1024
                        else (64, 2, None))
    bad_scale = 0.75 * hd ** -0.5 if scale is None else hd ** -0.5
    wa = heads * hd
    qkv = r(2, s_, 3, heads, hd, std=1.5)
    if hd == 128:
        qkv[..., 72:] = 0.0             # prepad_siglip_static's zero dims
    qkv = qkv.reshape(2, s_, 3 * wa).to(torch.bfloat16)
    lb = torch.log(torch.randint(1, 5, (2, s_), generator=g,
                                 device=dev).float())
    if name.startswith("9b"):
        return (attention.attention_qkv_int8(qkv, heads, hd, scale),
                attention.attention_qkv_int8_reference(qkv, heads, hd,
                                                       scale),
                1e-2, 2 ** -7, _share_apart, 1e-2,
                [attention.attention_qkv_int8(qkv, heads, hd, bad_scale),
                 attention.attention_qkv_int8_reference(
                     qkv, heads, hd, scale, q_block=64)])
    if name.startswith("K9"):
        k9 = lambda sc, b_: attention.attention_qkv(qkv, heads, hd, sc,
                                                    logit_bias=b_)
        return (k9(scale, lb),
                attention.attention_qkv_reference(qkv, heads, hd, scale,
                                                  logit_bias=lb),
                1e-2, 2 ** -7, _share_apart, 1e-2,
                [k9(bad_scale, lb), k9(scale, None)])
    ln = {"scale": 1.0 + r(W, std=0.1), "bias": r(W, std=0.1)}
    if hd == 128:
        out_w = r(heads, hd, W, std=wa ** -0.5)
        out_w[:, 72:] = 0.0
        out_w = out_w.reshape(wa, W)
    else:
        out_w = r(wa, W, std=wa ** -0.5)
    out_wq = quant.quantize_weight(out_w)
    a_out = torch.tensor(6.0, device=dev)
    x = r(2, s_, W).to(torch.bfloat16)
    rel = lambda got, ref: float((got.float() - ref.float()).norm()
                                 / (ref.float() - x.float()).norm())
    if name.startswith("K6"):
        args = (qkv, x, out_wq, r(W, std=0.1), a_out, heads, hd)
        return (int8_block.attn_out_int8(*args, scale),
                int8_block.attn_out_reference(*args, scale), 5e-2, 2e-2,
                rel, 5e-2, [int8_block.attn_out_int8(*args, bad_scale)])
    qkv_w = r(W, 3, heads, hd, std=1.5 * W ** -0.5)
    qkv_b = r(3, heads, hd, std=0.1)
    if hd == 128:
        qkv_w[..., 72:] = 0.0
        qkv_b[..., 72:] = 0.0
    wq = quant.quantize_weight(qkv_w.reshape(W, 3 * wa))
    args = (x, ln, wq, qkv_b.reshape(-1), out_wq, r(W, std=0.1),
            torch.tensor(4.0, device=dev), a_out, heads, hd, 1e-6)
    k1 = lambda sc, b_: int8_block.attn_sublayer_int8(*args, sc,
                                                      logit_bias=b_)
    return (k1(scale, lb),
            int8_block.attn_sublayer_reference(*args, scale, logit_bias=lb),
            5e-2, 2e-2, rel, 5e-2, [k1(bad_scale, lb), k1(scale, None)])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["K1-576", "K1-1024", "K6-576", "K6-1024",
                                  "K9-576", "K9-1024", "9b-576", "9b-1024",
                                  "K1-1296", "K1-1304", "K6-1296", "K6-1304",
                                  "K9-1296", "K9-1297", "9b-1296",
                                  "9b-1297"])
def test_large_attention_matches_twin_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    got, ref, atol, rtol, measure, limit, faults = _large_case(
        name, torch.device("cuda"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert measure(got, ref) <= limit
    assert all(measure(f, ref) > limit for f in faults)


# K10 past S = 256 and at head_dim 128: (B, S, heads, head_dim, scale);
# ragged S = 1000 is a multiple of 8 and not of the 64-row tile
K10_LONG = [(2, 576, 2, 64, None), (1, 1000, 2, 64, None),
            (1, 1024, 1, 128, 72 ** -0.5), (2, 512, 2, 128, None),
            (1, 1560, 1, 128, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K10_LONG)
def test_k10_long_sequences_match_twin_on_card(shape):
    """K10 against its twin on q, k, v of std 1.5: atol 1e-2 + rtol 2^-7
    and at most 1e-2 of the outputs more than a bf16 step apart; the
    launch goes through K10 (JAX's Pallas fit holds at each shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    b, s_, heads, hd, scale = shape
    assert attention.attention_qkv_bwd_fits(s_, heads * hd, hd)
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((b, s_, 3 * heads * hd), generator=g,
                      device="cuda") * 1.5
    qkv = qkv.to(torch.bfloat16)
    g_out = torch.randn((b, s_, heads * hd), generator=g,
                        device="cuda").to(torch.bfloat16)
    LAUNCHES.reset()
    got = attention.attention_qkv_bwd(qkv, g_out, heads, hd, scale)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {attention.KERNEL_BWD: 1}
    ref = attention.attention_qkv_bwd_reference(qkv, g_out, heads, hd, scale)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=2 ** -7)
    assert _share_apart(got, ref) <= 1e-2


# K9 and K10 (attention_sm90.cu) at the edges of their tiles: (kernel, B,
# S, heads, head_dim, scale, bias): S = 32 (one ragged tile, a warpgroup
# with no rows), ragged S = 200 and 1000, heads of 128 with so400m's scale
SM90_EDGES = [("K9", 2, 32, 2, 64, None, True),
              ("K9", 1, 1000, 2, 64, None, True),
              ("K9", 3, 200, 1, 128, None, False),
              ("K9", 1, 1000, 1, 128, 72 ** -0.5, True),
              ("K10", 2, 32, 2, 64, None, False),
              ("K10", 3, 200, 1, 128, None, False),
              ("K10", 1, 1000, 1, 128, 72 ** -0.5, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SM90_EDGES)
def test_sm90_attention_edges_match_twins_on_card(case):
    """K9 and K10 against their twins on q, k, v of std 1.5: atol 1e-2 +
    rtol 2^-7 and at most 1e-2 of the outputs more than a bf16 step
    apart, one launch of the kernel a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    name, b, s_, heads, hd, scale, with_bias = case
    g = torch.Generator(device="cuda").manual_seed(s_ + hd)
    qkv = (torch.randn((b, s_, 3 * heads * hd), generator=g, device="cuda")
           * 1.5).to(torch.bfloat16)
    LAUNCHES.reset()
    if name == "K9":
        lb = (torch.log(torch.randint(1, 5, (b, s_), generator=g,
                                      device="cuda").float())
              if with_bias else None)
        got = attention.attention_qkv(qkv, heads, hd, scale, logit_bias=lb)
        ref = attention.attention_qkv_reference(qkv, heads, hd, scale, lb)
        kernel = attention.KERNEL
    else:
        g_out = torch.randn((b, s_, heads * hd), generator=g,
                            device="cuda").to(torch.bfloat16)
        got = attention.attention_qkv_bwd(qkv, g_out, heads, hd, scale)
        ref = attention.attention_qkv_bwd_reference(qkv, g_out, heads, hd,
                                                    scale)
        kernel = attention.KERNEL_BWD
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {kernel: 1}
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=2 ** -7)
    assert _share_apart(got, ref) <= 1e-2


@pytest.mark.gpu
def test_k10_route_takes_the_twin_vjp_where_jax_does_on_card():
    """so400m-512's padded heads (d 128, S 1024, W 2048) miss JAX's 12 MiB
    fit: no K10 launch, the twin's VJP counted once, equal to autograd
    through the forward's twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    heads, hd = 16, 128
    assert not attention.attention_qkv_bwd_fits(1024, heads * hd, hd)
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn((1, 1024, 3 * heads * hd), generator=g,
                      device="cuda").to(torch.bfloat16)
    g_out = torch.randn((1, 1024, heads * hd), generator=g,
                        device="cuda").to(torch.bfloat16)
    LAUNCHES.reset()
    got = attention.attention_qkv_bwd(qkv, g_out, heads, hd, 72 ** -0.5)
    assert LAUNCHES.snapshot() == {attention.KERNEL_BWD_TWIN: 1}
    x = qkv.clone().requires_grad_(True)
    attention.attention_qkv_reference(x, heads, hd, 72 ** -0.5).backward(
        g_out)
    torch.testing.assert_close(got, x.grad)


@pytest.mark.gpu
def test_ln_passes_at_width_1152_on_card():
    """K4, K8 (codes within one step: f32 LN ties) and K5 at so400m's
    width, 4.5 chunks of 8 a lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
    w = 1152
    sc, bi = 1.0 + r(w, std=0.1), r(w, std=0.1)
    x = (r(300, w) * 3 + 0.5).to(torch.bfloat16)
    torch.testing.assert_close(
        layernorm.layer_norm_fused(x, sc, bi).float(),
        layernorm.layer_norm_reference(x, sc, bi).float(), atol=1e-6,
        rtol=2 ** -7)
    a = torch.tensor(3.0, device=dev)
    d = (layernorm.layer_norm_quant(x, sc, bi, a).int()
         - layernorm.layer_norm_quant_reference(x, sc, bi, a).int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    wq = quant.quantize_weight(r(w, 384, std=w ** -0.5))
    args = (x, {"scale": sc, "bias": bi}, wq, r(384, std=0.1), a)
    torch.testing.assert_close(int8_block.ln_qkv_int8(*args).float(),
                               int8_block.ln_qkv_reference(*args).float(),
                               atol=5e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_engine_matches_twins_on_card(int8):
    """A 2-layer base-256-width engine (bf16 tower, or W8A8 with the
    deployed ToMe and patch ToMe) against the same parameters through the
    twins on the card, at B=2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import init_params
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor)
    from tpudf_torch.serve.engine import DetectEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(CONFIGS["base-256"], layers=2)
    p = tree_map(lambda t: t.cuda(),
                 init_params(torch.Generator().manual_seed(0), cfg))
    eng = DetectEngine(cfg, p["backbone"], p["head"], p["freq"], p["fusion"],
                       CoralCutpoints.default())
    if int8:
        eng = dataclasses.replace(
            eng, tome_r=DEPLOYED_TOME_R, tome_floor=deployed_floor(256),
            patch_tome_r=DEPLOYED_PATCH_TOME_R,
            patch_tome_floor=deployed_patch_floor(256)).quantize()
    twin = dataclasses.replace(eng, kernels=TWINS)
    px = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3),
                                           np.uint8)
    for fast in (False, True):
        got = eng.fetch_batch(eng.dispatch_batch(px, fast), fast)
        ref = twin.fetch_batch(twin.dispatch_batch(px, fast), fast)
        assert set(got) == set(ref)
        for k in got:
            assert np.isfinite(got[k]).all(), k
        probs = ["p_blend", "visual_prob"] + ([] if fast else ["patch_probs"])
        for k in probs:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-2, err_msg=k)
        feats, feats_twin = (e.pooled_features(px, fast) for e in (eng, twin))
        for k in feats:
            cos = torch.nn.functional.cosine_similarity(
                feats[k].float(), feats_twin[k].float(), dim=-1)
            assert float(cos.min()) >= 0.99, k


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_report_matches_twins_on_card(int8):
    """The image report (tpudf_torch.serve.report.predict_images) of the
    engine above on the card against the same engine through the twins,
    full and fast, then full with the three artifacts attached: exact
    launches (a report launches what the engine's request does: none in
    the tail), the reports by `chip_smoke.report_vs` (strings, ints and
    bools equal but for a step at a threshold, the core's floats by the
    engine rule, the battery's by the goldens'), and the battery on the
    card against the port's on the CPU (`chip_smoke.battery_vs_cpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import chip_smoke as cs
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import init_params
    from tpudf_torch.fuse.bayesian import FEATURES, fit_bayes_calibration
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor)
    from tpudf_torch.serve.engine import DetectEngine
    from tpudf_torch.serve.report import predict_images
    from tpudf_torch.train.gbdt import to_tree_ensemble, train_gbdt
    cfg = dataclasses.replace(CONFIGS["base-256"], layers=2)
    p = tree_map(lambda t: t.cuda(),
                 init_params(torch.Generator().manual_seed(0), cfg))
    eng = DetectEngine(cfg, p["backbone"], p["head"], p["freq"], p["fusion"],
                       CoralCutpoints.default())
    if int8:
        eng = dataclasses.replace(
            eng, tome_r=DEPLOYED_TOME_R, tome_floor=deployed_floor(256),
            patch_tome_r=DEPLOYED_PATCH_TOME_R,
            patch_tome_floor=deployed_patch_floor(256)).quantize()
    twin = dataclasses.replace(eng, kernels=TWINS)
    expect = cs.engine_expect(2, 256)
    px = cs.report_images(4, 256, seed=0)
    e = "B" if int8 else "A"
    for fast in (False, True):
        LAUNCHES.reset()
        got = cs.report_plain(predict_images(eng, px, fast=fast))
        assert LAUNCHES.snapshot() == expect[(e, "fast" if fast else "full")]
        want = cs.report_plain(predict_images(twin, px, fast=fast))
        cs.report_vs(f"report fast={fast}", got, want, int8)
        if not fast:
            cs.battery_vs_cpu("report", got, px)
    rng = np.random.default_rng(1)
    x = rng.random((300, 19))
    y = (rng.random(300) < 0.2 + 0.6 * x[:, 3]).astype(np.float64)
    held = {k: rng.random(200) for k in FEATURES}
    arts = dict(mean_real=rng.standard_normal(cfg.width).astype(np.float32),
                gbdt=to_tree_ensemble(train_gbdt(x, y, n_trees=8), 1.2, 0.0),
                bayes_calibration=fit_bayes_calibration(
                    held, (held["forensic"] > 0.5).astype(float)))
    eng_a, twin_a = (dataclasses.replace(m, **arts) for m in (eng, twin))
    got = cs.report_plain(predict_images(eng_a, px))
    cs.report_vs("report with artifacts", got,
                 cs.report_plain(predict_images(twin_a, px)), int8,
                 arts["gbdt"])
    assert all(r["xgb_fusion_prob"] is not None for r in got)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_video_report_matches_twins_on_card(int8):
    """The video report (tpudf_torch.serve.report.predict_video) of a
    2-layer base-256 engine on a 12-frame clip on the card against the
    same engine through the twins, by chip_smoke.py phase 3v's rules:
    exact launches (`video_expect`: the fast batch, the battery's tower
    forward without ToMe, the chosen frame's full request), the battery's
    signals bit-equal, the tower's floats by the engine rule, a label or
    the chosen frame that differs shown to be a step (`video_vs`);
    embed_batch against the twins (`embeds_vs`); the battery against the
    port's on the CPU and bit-equal to itself with TF32 off
    (`video_battery_vs_cpu`); the face nets' outputs, the landmarks in px
    and the face trio against the port's on the CPU, a crop corner a
    pixel apart shown to be a step (`face_vs_cpu`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import chip_smoke as cs
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.entry import init_params
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                      deployed_floor, deployed_patch_floor)
    from tpudf_torch.serve.engine import DetectEngine
    cfg = dataclasses.replace(CONFIGS["base-256"], layers=2)
    p = tree_map(lambda t: t.cuda(),
                 init_params(torch.Generator().manual_seed(0), cfg))
    eng = DetectEngine(cfg, p["backbone"], p["head"], p["freq"], p["fusion"],
                       CoralCutpoints.default())
    if int8:
        eng = dataclasses.replace(
            eng, tome_r=DEPLOYED_TOME_R, tome_floor=deployed_floor(256),
            patch_tome_r=DEPLOYED_PATCH_TOME_R,
            patch_tome_floor=deployed_patch_floor(256)).quantize()
    twin = dataclasses.replace(eng, kernels=TWINS)
    e = "B" if int8 else "A"
    clip = cs.video_clip(cs.VIDEO_T, 256, seed=40)
    dev = torch.device("cuda")
    rep, *_ = cs.video_request("video", eng, twin, clip, int8,
                               cs.engine_expect(2, 256), 2, e, dev)
    cs.embeds_vs("video", eng, twin, clip[:3])
    cs.video_battery_vs_cpu("video", rep, clip, dev)
    cs.face_vs_cpu("video", rep, clip, dev)


@pytest.mark.gpu
def test_mtl_train_step_matches_twins_on_card():
    """One MTL train step of a 3-layer base-256-width tower with layers 0-1
    frozen (K13, K9, K14 forward, K10 backward on the top layer), B=2,
    against the same parameters through the twins: the loss within 1e-2
    and the step's gradient cosine >= 0.99 for the top block, the heads and
    the decoder, and each q / k / v third of the top block's qkv_w gradient
    within a relative error of 5e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import DEFAULT_POLICY, tree_map
    from tpudf_torch.models.segformer import MTLConfig, init_mtl
    from tpudf_torch.models.siglip import CONFIGS
    from tpudf_torch.ops.routes import KERNELS, TWINS
    from tpudf_torch.train.mtl import make_mtl_train_step
    from tpudf_torch.train.steps import make_optimizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MTLConfig(dataclasses.replace(CONFIGS["base-256"], layers=3),
                    seg_layers=(0, -1), embed_dim=64)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"pixels": torch.rand((2, 256, 256, 3), generator=g,
                                  device="cuda") * 2 - 1,
             "cls": torch.tensor([0, 2], device="cuda"),
             "mask": (torch.rand((2, 256, 256), generator=g, device="cuda")
                      > 0.7).float(),
             "has_mask": torch.tensor([0.0, 1.0], device="cuda")}
    losses, grads = [], []
    for ks in (KERNELS, TWINS):
        params = tree_map(lambda t: t.cuda(), init_mtl(
            torch.Generator().manual_seed(0), cfg))
        init_fn, step = make_mtl_train_step(
            cfg, make_optimizer(1e-4), DEFAULT_POLICY, freeze_below=2,
            kernels=ks)
        LAUNCHES.reset()
        state, m = step(init_fn(params), batch, None, 1.0, 0.5)
        torch.cuda.synchronize()
        if ks is KERNELS:
            assert LAUNCHES.snapshot()["attention_qkv_bwd"] == 1
        losses.append(float(m["loss"]))
        p = state.params
        grads.append({
            "top block": p["backbone"]["blocks"]["attn"]["qkv_w"].grad[2:],
            "heads": p["cls_head"]["w"].grad,
            "decoder": p["decoder"]["fuse"]["w"].grad})
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-2
    for k in grads[0]:
        cos = torch.nn.functional.cosine_similarity(
            grads[0][k].flatten(), grads[1][k].flatten(), dim=0)
        assert float(cos) >= 0.99, k
    # K10's dQ, dK and dV each reach one third of the top block's qkv_w
    w = cfg.backbone.width
    for j, part in enumerate("qkv"):
        got, want = (g["top block"][..., j * w:(j + 1) * w] for g in grads)
        err = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(
            want)
        assert float(err) <= 5e-2, part


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["PPP", "XXX", "LLL", "PXP", "XPX"])
def test_int8_routes_match_twins_on_card(route, monkeypatch):
    """A 2-layer base-256-width W8A8 tower under one TPUDF_INT8_KERNELS
    route (B=2, without and with the deployed ToMe) against the same route
    through the twins: pooled cosine >= 0.99, and each route's own kernels
    launched. LLL runs at 128 px (S = 64): JAX's whole-layer kernel, whose
    decision the route follows, does not fit base-256's S = 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.models.siglip import CONFIGS, init_siglip, siglip_forward
    from tpudf_torch.ops.routes import TWINS
    from tpudf_torch.ops.tome import DEPLOYED_TOME_R, deployed_floor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
    size = 128 if route == "LLL" else 256
    cfg = dataclasses.replace(CONFIGS["base-256"], layers=2, image_size=size)
    p = tree_map(lambda t: t.cuda(),
                 init_siglip(torch.Generator().manual_seed(0), cfg))
    g = torch.Generator(device="cuda").manual_seed(1)
    px = torch.rand((2, size, size, 3), generator=g, device="cuda") * 2 - 1
    q = add_kernel_layout(quant.quantize_siglip_static(
        p, quant.calibrate_siglip_act_scales(p, cfg, px), cfg))
    want = {"PPP": "ln_qkv_int8", "XXX": "layer_norm_quant",
            "LLL": "siglip_layer_int8", "PXP": "ln_qkv_int8",
            "XPX": "attn_out_int8"}[route]
    for tome in (0, DEPLOYED_TOME_R):
        kw = dict(tome_r=tome, tome_floor=deployed_floor(256))
        LAUNCHES.reset()
        got = siglip_forward(q, px, cfg, **kw)["pooled"]
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot().get(want, 0) >= 1, LAUNCHES.snapshot()
        ref = siglip_forward(q, px, cfg, kernels=TWINS, **kw)["pooled"]
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float(),
                                                    dim=-1)
        assert torch.isfinite(got.float()).all()
        assert float(cos.min()) >= 0.99, (tome, cos)


@pytest.mark.gpu
def test_dynamic_int8_tower_matches_twins_on_card():
    """A 2-layer base-256-width dynamic-int8 tower (quantize_siglip, no
    activation scales: per-row int8 products, K9, K4) at B=2 against the
    same tree through the twins: pooled cosine >= 0.99, its int8 GEMM and
    K9 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.core.precision import tree_map
    from tpudf_torch.models.siglip import CONFIGS, init_siglip, siglip_forward
    from tpudf_torch.ops.routes import TWINS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(CONFIGS["base-256"], layers=2)
    p = tree_map(lambda t: t.cuda(),
                 init_siglip(torch.Generator().manual_seed(0), cfg))
    q = add_kernel_layout(quant.quantize_siglip(p))
    g = torch.Generator(device="cuda").manual_seed(1)
    px = torch.rand((2, 256, 256, 3), generator=g, device="cuda") * 2 - 1
    LAUNCHES.reset()
    got = siglip_forward(q, px, cfg)["pooled"]
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {"int8_gemm": 8, "attention_qkv": 2,
                                   "layer_norm_fused": 6}
    ref = siglip_forward(q, px, cfg, kernels=TWINS)["pooled"]
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float(),
                                                dim=-1)
    assert torch.isfinite(got.float()).all()
    assert float(cos.min()) >= 0.99, cos


# (B, H, Sq, Skv, D): ragged Skv, Sq != Skv, a single query, heads of 72
_PLAIN_SHAPES = [(2, 3, 100, 100, 64), (2, 2, 3, 100, 72),
                 (1, 2, 77, 130, 128), (2, 2, 1, 577, 64),
                 (1, 2, 130, 64, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", _PLAIN_SHAPES)
def test_plain_attention_matches_twin_on_card(shape, dtype, bshd):
    """Kernels 11 (B, H, S, D) and 12 (B, S, H, D) against their twins on
    q, k, v of std 1.5: bf16 within atol 1e-2 + rtol 2^-7 and at most 1e-2
    of the outputs more than a bf16 step apart, f32 within atol 5e-4 +
    rtol 1e-3 (JAX's own bound); one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, sq, skv, d = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    r = lambda s: (torch.randn(s, generator=g, device="cuda") * 1.5).to(dt)
    if bshd:
        q, k, v = r((b, sq, h, d)), r((b, skv, h, d)), r((b, skv, h, d))
        fn, twin, name = (attention.attention_bshd, attention._reference_bshd,
                          attention.KERNEL_BSHD)
    else:
        q, k, v = r((b, h, sq, d)), r((b, h, skv, d)), r((b, h, skv, d))
        fn, twin, name = (attention.attention, attention.attention_reference,
                          attention.KERNEL_PLAIN)
    LAUNCHES.reset()
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {name: 1}
    ref = twin(q, k, v)
    assert got.shape == q.shape and got.dtype == dt
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)
        assert _share_apart(got, ref) <= 1e-2


@pytest.mark.gpu
def test_plain_attention_gradient_and_range_on_card():
    """The gradient through `attention` (kernel 11 forward, the twin's VJP
    backward) equals the twin's own (f32, 1e-5); a head_dim or dtype
    outside the kernels' range raises on a CUDA tensor, and JAX's XLA
    route (Sq > 4096) runs the twin without a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((2, 2, 40, 64), generator=g, device="cuda")
               .requires_grad_() for _ in range(3))
    ct = torch.randn((2, 2, 40, 64), generator=g, device="cuda")
    got = torch.autograd.grad(attention.attention(q, k, v), (q, k, v), ct)
    ref = torch.autograd.grad(attention.attention_reference(q, k, v),
                              (q, k, v), ct)
    for a, b_ in zip(got, ref):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)
    x = torch.zeros((1, 1, 8, 96), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.attention(x, x, x)
    with pytest.raises(ValueError):
        attention.attention_bshd(*(torch.zeros((1, 8, 1, 64), device="cuda",
                                               dtype=torch.float16),) * 3)
    long_q = torch.zeros((1, 1, 4097, 64), device="cuda")
    LAUNCHES.reset()
    attention.attention(long_q, long_q[:, :, :8], long_q[:, :, :8])
    assert LAUNCHES.snapshot() == {}


@pytest.mark.gpu
@pytest.mark.parametrize("bshd", [False, True])
def test_plain_attention_f32_at_an_odd_offset_on_card(bshd):
    """f32 k and v that start one float past a 16-byte boundary (contiguous
    views at storage offset 1, where the kernel's 16-byte copies would
    fault) are refused with a ValueError before any launch, and the card
    stays usable: the same values, aligned, then match the twin within
    atol 5e-4 + rtol 1e-3 in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = ([(2, 100, 3, 64), (2, 130, 3, 64)] if bshd
              else [(2, 3, 100, 64), (2, 3, 130, 64)])
    q, k, v = ((torch.randn(torch.Size(s).numel() + 1, generator=g,
                            device="cuda") * 1.5)[1:].view(s)
               for s in (shapes[0], shapes[1], shapes[1]))
    assert k.data_ptr() % 16 == 4 and k.is_contiguous()
    fn, twin, name = ((attention.attention_bshd, attention._reference_bshd,
                       attention.KERNEL_BSHD) if bshd
                      else (attention.attention, attention.attention_reference,
                            attention.KERNEL_PLAIN))
    LAUNCHES.reset()
    with pytest.raises(ValueError):
        fn(q.clone(), k, v)
    assert LAUNCHES.snapshot() == {}
    q, k, v = q.clone(), k.clone(), v.clone()
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {name: 1}
    torch.testing.assert_close(got, twin(q, k, v), atol=5e-4, rtol=1e-3)


_PROBES = ["15-bf16", "15-int8"] + [f"16-{v}" for v in p16.VARIANTS] + ["17"]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", _PROBES)
def test_probe_kernels_match_twins_on_card(kernel):
    """Kernels 15-17 at (M, K, N) = (1024, 128, 256) and (2, 300, 768) with
    heads of 128, one launch each (17: its pre-pass and its main pass):
    within one bf16 step of the twin (15's
    bf16 product + 1e-6, k_full + 1e-6, k_bf16_epi two steps), k_pure
    bit-equal to the twin and to torch._int_mm, 17 with at most 1e-2 of
    its outputs a bf16 step apart and all within atol 1e-2 + rtol 2^-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    m, k, n = 1024, 128, 256
    x_bf = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    x_i8 = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                         dtype=torch.int8)
    wt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand((n,), generator=g, device=dev) * 0.01 + 0.01
    b = torch.rand((n,), generator=g, device=dev)
    steps, atol = 1, 0.0
    LAUNCHES.reset()
    if kernel == "17":
        qkv = torch.randn((2, 300, 768), generator=g, device=dev).to(
            torch.bfloat16)
        got = p17.attention_qkv_int8_static(qkv, 2, 128)
        ref = p17.attention_qkv_int8_static_reference(qkv, 2, 128)
        counter = (p17.KERNEL_PREPASS, p17.KERNEL)
    elif kernel == "15-bf16":
        w = (torch.randn((k, n), generator=g, device=dev) * 0.03).to(
            torch.bfloat16)
        got, ref = p15.bf16_matmul(x_bf, w), p15.bf16_matmul_reference(x_bf, w)
        counter, atol = p15.KERNEL_BF16, 1e-6
    elif kernel == "15-int8":
        got = p15.int8_matmul_staticq(x_bf, wt, s)
        ref = p15.int8_matmul_staticq_reference(x_bf, wt, s)
        counter = p15.KERNEL_INT8
    else:
        v = kernel[3:]
        x = x_bf if v in p16.QUANTISED else x_i8
        got = p16.fc1_matmul(v, x, wt, s, b)
        ref = p16.fc1_matmul_reference(v, x, wt, s, b)
        counter = p16.KERNELS[v]
        steps, atol = {"full": (1, 1e-6), "bf16_epi": (2, 0.0)}.get(
            v, (1, 0.0))
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {c: 1 for c in (
        counter if isinstance(counter, tuple) else (counter,))}
    if kernel == "16-pure":
        assert torch.equal(got, ref)
        assert torch.equal(got, torch._int_mm(x_i8, wt.t()))
        return
    a, r = got.float(), ref.float()
    if kernel == "17":
        assert _share_apart(a, r) <= 1e-2
        torch.testing.assert_close(a, r, atol=1e-2, rtol=2 ** -7)
        return
    m_ab = torch.maximum(a.abs(), r.abs()).clamp_min(1e-30)
    lim = steps * torch.exp2(torch.floor(torch.log2(m_ab)) - 7) + atol
    assert bool(((a - r).abs() <= lim).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["S=1000", "S=1000 negative", "S=64"])
def test_k17_wgmma_pass_on_card(case):
    """Kernel 17's two launches (csrc/attention_i8.cu, chip_smoke.py phase
    2e) at (2, S, 6 heads of 128), S = 1000 (keys past S on the last tile;
    also with every real score negative) and 64: the pre-pass's codes
    bit-equal to the twin's, the output by 9b's card rule, and that rule
    failing on the planted faults (`chip_smoke.k17_fault`: the keys past S
    in the max (negative scores only) or in l, a 64-key tile skipped, o
    without ap; and aq 3.1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.core.backend import LAUNCHES
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    heads, d = 6, 128
    scale = d ** -0.5
    s = int(case.split()[0][2:])
    qkv = (cs.k17_negative(g, 2, s, heads, d) if "negative" in case else
           torch.randn((2, s, 3 * heads * d), generator=g, device=dev).to(
               torch.bfloat16))
    codes = p17.static_prepass(qkv, heads)
    for got, want in zip(codes, p17.static_codes_reference(qkv, heads)[1:]):
        assert torch.equal(got, want)
    LAUNCHES.reset()
    got = p17.attention_qkv_int8_static(qkv, heads, d, scale)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {p17.KERNEL_PREPASS: 1, p17.KERNEL: 1}
    ref = p17.attention_qkv_int8_static_reference(qkv, heads, d, scale)
    assert cs.probe_agrees("17", got, ref)[0]
    faults = list(cs.K17_FAULTS[:2] if "negative" in case else ())
    faults += list(cs.K17_FAULTS[2 if s > 64 else 3:])
    for f in faults:
        assert not cs.probe_agrees("17", got, cs.k17_fault(
            qkv, heads, scale, f))[0], f
    assert not cs.probe_agrees("17", got,
                               p17.attention_qkv_int8_static_reference(
                                   qkv, heads, d, scale, aq=3.1))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["staticq"] + list(p16.QUANTISED))
def test_probe_quant_routes_match_on_card(variant):
    """The quantising GEMMs' two forms (`common.quant_gemm_cuda`): at K =
    768 (M 1024, N 640: a half 256-wide tile) the split form (the codes'
    row pass, then the int8 GEMM) bit-equal to the one launch; at K = 1600
    the wrapper's own route is the split form, counted on its own counter,
    within PROBE_TOL of the twin, and not with the codes' last 64 columns
    zeroed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.probes import common
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    n = 640
    s = torch.rand((n,), generator=g, device=dev) * 0.01 + 0.01
    b = None if variant == "staticq" else torch.rand((n,), generator=g,
                                                     device=dev)
    for k in (768, 1600):
        x = torch.randn((1024, k), generator=g, device=dev).to(torch.bfloat16)
        wt = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        split = common.quant_gemm_split(variant, x, wt, s, b, None)
        if k == 768:
            one = common.quant_gemm_cuda(variant, x, wt, s, b, None)
            assert torch.equal(one, split)
            continue
        LAUNCHES.reset()
        if variant == "staticq":
            got = p15.int8_matmul_staticq(x, wt, s)
            twin = lambda xx: p15.int8_matmul_staticq_reference(xx, wt, s)
            counter = p15.KERNEL_INT8_SPLIT
        else:
            got = p16.fc1_matmul(variant, x, wt, s, b)
            twin = lambda xx: p16.fc1_matmul_reference(variant, xx, wt, s, b)
            counter = p16.KERNELS_SPLIT[variant]
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {counter: 1}
        assert torch.equal(got, split)
        steps, atol = {"full": (1, 1e-6), "bf16_epi": (2, 0.0)}.get(
            variant, (1, 0.0))
        cut = x.clone()
        cut[:, -64:] = 0
        for ref, want in ((twin(x), True), (twin(cut), False)):
            a, r = got.float(), ref.float()
            m_ab = torch.maximum(a.abs(), r.abs()).clamp_min(1e-30)
            lim = steps * torch.exp2(torch.floor(torch.log2(m_ab)) - 7) + atol
            assert bool(((a - r).abs() <= lim).all()) == want


# the bf16 GEMM of K13, K14 and kernel 15 (csrc/bf16_gemm_sm90.cu): a
# ragged M with K % 64 == 32 and N % 256 == 128, a half tile after two
# whole ones, and the QKV product of the float engine's full analysis
_GEMM_SHAPES = [(300, 800, 384), (300, 768, 640), (108544, 768, 2304)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,with_bias", [(0, True), (0, False), (1, True),
                                            (2, True)])
@pytest.mark.parametrize("shape", _GEMM_SHAPES)
def test_bf16_gemm_matches_twin_on_card(shape, mode, with_bias):
    """The launch in each epilogue mode (MODE 0 also without a bias, as
    kernel 15 runs it) against `linear_fused_reference`: atol 1e-2 + rtol
    2^-7 and at most 1e-2 of the outputs more than a bf16 step apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device="cuda") * std
    a = r(m, k).to(torch.bfloat16)
    w = r(k, n, std=k ** -0.5).to(torch.bfloat16)
    bias = r(n, std=0.1) if with_bias else None
    res = r(m, n).to(torch.bfloat16) if mode == linear.GEMM_RESIDUAL else None
    got = linear.bf16_gemm_cuda(a, w, bias, mode, res)
    ref = linear.linear_fused_reference(
        a, w, bias, residual=res,
        activation="gelu" if mode == linear.GEMM_GELU else None)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=2 ** -7)
    assert _share_apart(got, ref) <= 1e-2


# heads of 16, 32, 256 and 384-1280 (chip_smoke.py phase 2h): (kernel,
# heads, head_dim, S) at W = 768 (1280 for 640 and 1280), q, k, v of std
# 1.5; K9 and 9b at a ragged S = 577, K10, K1 and K6 at S = 584 (JAX's
# routes need S % 8 == 0 there)
_HEADDIM = [("K9", 48, 16, 577), ("K9", 24, 32, 576), ("K9", 3, 256, 577),
            ("9b", 48, 16, 576), ("9b", 24, 32, 577), ("9b", 3, 256, 577),
            ("K10", 48, 16, 584), ("K10", 24, 32, 576), ("K10", 3, 256, 584),
            ("K1", 48, 16, 584), ("K1", 24, 32, 576), ("K1", 3, 256, 584),
            ("K6", 48, 16, 576), ("K6", 24, 32, 584), ("K6", 3, 256, 576),
            ("K9", 2, 384, 577), ("K9", 1, 1280, 576), ("9b", 2, 384, 577),
            ("9b", 2, 640, 576), ("K10", 2, 384, 584), ("K10", 1, 1280, 576),
            ("K1", 2, 384, 584), ("K1", 2, 640, 576), ("K1", 1, 1280, 584),
            ("K6", 2, 384, 576), ("K6", 1, 1280, 584)]


def _padded_junk(fn, t, heads, hd, scale, *more):
    """The padded route with a planted fault: the padding of each head's
    64 columns holds values of std 1.5, not zeros."""
    to = attention.PAD_HEAD_DIM
    g = torch.Generator(device=t.device).manual_seed(7)

    def pad(u):
        p = attention.pad_heads(u, heads, hd, to)
        n = p.shape[-1] // (heads * to)
        p = p.reshape(*p.shape[:-1], n, heads, to).clone()
        p[..., hd:] = (1.5 * torch.randn(p[..., hd:].shape, generator=g,
                                         device=p.device)).to(p.dtype)
        return p.reshape(*p.shape[:-3], n * heads * to)

    return attention.unpad_heads(fn(pad(t), *(pad(m) for m in more), heads,
                                    to, scale), heads, hd, to)


def _k10_f64(qkv, g, heads, hd, scale):
    """K10's function in float64 on its bf16 inputs (no rounding between
    the products): [dq | dk | dv]."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    hf = lambda t: t.reshape(b, s, heads, hd).transpose(1, 2).double()
    q, k, v = (hf(qkv[..., i * w:(i + 1) * w]) for i in range(3))
    gh = hf(g)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return torch.cat([t.transpose(1, 2).reshape(b, s, w)
                      for t in (ds @ k, ds.transpose(-1, -2) @ q,
                                p.transpose(-1, -2) @ gh)], dim=-1)


def _slice_dropped(out, heads, hd, parts=1):
    """A head of 256 or more whose second 128-column slice was never
    computed."""
    o = out.clone().reshape(*out.shape[:-1], parts, heads, hd)
    o[..., 128:256] = 0
    return o.reshape(out.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", _HEADDIM,
                         ids=[f"{k}-{h}x{d}-{s}" for k, h, d, s in _HEADDIM])
def test_head_dims_match_twin_on_card(case):
    """K9, 9b and K10 (padded to 64 at heads of 16 and 32, native at 256,
    on their wide kernels at 384-1280) and K1 / K6 (K1 padded to 64 at 16
    and 32, K6 as two launches at the wide heads) against their twins, one
    launch a call, by the card rules of chip_smoke.py's phases 2b / 2d /
    2h (K9, 9b, K10: at most 1e-2 of the outputs a bf16 step apart, K9
    also atol 1e-2 + rtol 2^-7, K10 at most twice the twin's largest error
    from float64; K1, K6: atol 5e-2 + rtol 2e-2 and 5e-2 of the attention
    part); the planted faults (the scale of a 64-wide head, the padding
    non-zero, the second slice dropped) fail the same rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.core.backend import LAUNCHES
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, heads, hd, s = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(heads + hd + s)
    r = lambda *sh, std=1.0: torch.randn(sh, generator=g, device=dev) * std
    w = heads * hd
    scale = hd ** -0.5
    padded = hd in attention.PADDED_HEAD_DIMS
    bad = attention.PAD_HEAD_DIM ** -0.5 if padded else 0.75 * scale
    qkv = r(1, s, 3 * w, std=1.5).to(torch.bfloat16)
    LAUNCHES.reset()
    if kernel in ("K9", "9b", "K10"):
        if kernel == "K9":
            fn, twin, counter = (attention.attention_qkv,
                                 attention.attention_qkv_reference,
                                 attention.KERNEL)
            more = ()
        elif kernel == "9b":
            fn, twin, counter = (attention.attention_qkv_int8,
                                 attention.attention_qkv_int8_reference,
                                 attention.KERNEL_INT8)
            more = ()
        else:
            fn, twin, counter = (attention.attention_qkv_bwd,
                                 attention.attention_qkv_bwd_reference,
                                 attention.KERNEL_BWD)
            more = (r(1, s, w).to(torch.bfloat16),)
        got = fn(qkv, *more, heads, hd, scale)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {counter: 1}
        ref = twin(qkv, *more, heads, hd, scale)
        faults = [fn(qkv, *more, heads, hd, bad)]
        faults.append(_padded_junk(fn, qkv, heads, hd, scale, *more) if padded
                      else _slice_dropped(got, heads, hd,
                                          3 if kernel == "K10" else 1))
        if kernel == "K9":
            torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                       rtol=2 ** -7)
        if kernel == "K10":
            exact = _k10_f64(qkv, *more, heads, hd, scale)
            far = lambda t: float((t.double() - exact).abs().max())
            assert far(got) <= 2.0 * far(ref)
            assert all(far(f) > 2.0 * far(ref) for f in faults)
        assert _share_apart(got, ref) <= 1e-2
        assert all(_share_apart(f, ref) > 1e-2 for f in faults)
        return
    x = r(1, s, w).to(torch.bfloat16)
    out_wq = quant.quantize_weight(r(w, w, std=w ** -0.5))
    out_b, a_out = r(w, std=0.1), torch.tensor(6.0, device=dev)
    rel = lambda got, ref: float((got.float() - ref.float()).norm()
                                 / (ref.float() - x.float()).norm())
    if kernel == "K6":
        args = (qkv, x, out_wq, out_b, a_out, heads, hd)
        got = int8_block.attn_out_int8(*args, scale)
        counter = (int8_block.KERNEL_ATTN_OUT_SPLIT
                   if hd in attention.WIDE_HEAD_DIMS
                   else int8_block.KERNEL_ATTN_OUT)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {counter: 1}
        ref = int8_block.attn_out_reference(*args, scale)
        faults = [int8_block.attn_out_int8(*args, bad)]
    else:
        ln = {"scale": 1.0 + r(w, std=0.1), "bias": r(w, std=0.1)}
        wq = quant.quantize_weight(r(w, 3 * w, std=1.5 * w ** -0.5))
        lb = torch.log(torch.randint(1, 5, (1, s), generator=g,
                                     device=dev).float())
        args = (x, ln, wq, r(3 * w, std=0.1), out_wq, out_b,
                torch.tensor(4.0, device=dev), a_out, heads, hd, 1e-6)
        got = int8_block.attn_sublayer_int8(*args, scale, logit_bias=lb)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {int8_block.KERNEL: 1}
        ref = int8_block.attn_sublayer_reference(*args, scale, logit_bias=lb)
        faults = [int8_block.attn_sublayer_int8(*args, bad, logit_bias=lb),
                  int8_block.attn_sublayer_int8(*args, scale)]
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2,
                               rtol=2e-2)
    assert rel(got, ref) <= 5e-2
    assert all(rel(f, ref) > 5e-2 for f in faults)


# K1's attention launch alone (csrc/attention_sm90.cu; chip_smoke.py phase
# 2j) at the first layer of each detect core, B = 8: (label, S, heads,
# head_dim, live columns); so400m's heads of 72 in 128-wide slots run on the
# 80-wide tile
_K1_ATTN = [("base-256", 256, 12, 64, 64), ("large-384", 576, 16, 64, 64),
            ("so400m-512", 1024, 16, 128, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _K1_ATTN, ids=[c[0] for c in _K1_ATTN])
def test_k1_attention_matches_twin_on_card(case):
    """K1's attention kernel (wgmma + TMA, int8 codes of the f32 o) against
    its twin, with and without the key bias: at most 1e-3 of the codes
    differ, none by more than one; the scale and the dropped bias fail
    that rule, and on the 80-wide tile the codes of columns 80-127 are 0
    in a buffer pre-filled with other codes, and columns 72-79 that hold
    values are read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    label, s, heads, hd, live = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(s + hd)
    b, a = 8, torch.tensor(6.0, device=dev)
    sd = live ** -0.5
    arg = None if live == hd else live

    def agrees(got, ref):
        d = (got.int() - ref.int()).abs()
        return int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3

    qkv = torch.randn((b, s, 3, heads, hd), generator=g, device=dev) * 1.5
    qkv[..., live:] = 0.0
    qkv = qkv.reshape(b, s, -1).to(torch.bfloat16)
    lb = torch.log(torch.randint(1, 9, (b, s), generator=g,
                                 device=dev).float())
    k1 = lambda q=qkv, sc=sd, bias=None, out=None: int8_block.attention_i8(
        q, heads, hd, a, sc, logit_bias=bias, live=arg, out=out)
    for bias in (None, lb):
        ref = int8_block.attention_i8_reference(qkv, heads, hd, a, sd,
                                                logit_bias=bias)
        assert agrees(k1(bias=bias), ref)
        assert not agrees(k1(sc=0.75 * sd, bias=bias), ref)
        if bias is not None:
            assert not agrees(k1(), ref)
    if arg is None:
        return
    buf = torch.full((b * s, heads * hd), 85, dtype=torch.int8, device=dev)
    got = k1(out=buf)
    torch.cuda.synchronize()
    assert int(got.reshape(b * s, heads, hd)[..., 80:].abs().max()) == 0
    assert agrees(got, int8_block.attention_i8_reference(qkv, heads, hd, a,
                                                         sd))
    # qkv with values in columns 72-79: read, as the twin reads them; the
    # same inputs with those columns zero (what a 72-wide read sees) differ
    q80 = qkv.clone().reshape(b, s, 3, heads, hd)
    q80[..., live:80] = (1.5 * torch.randn(q80[..., live:80].shape,
                                           generator=g, device=dev)).to(
        torch.bfloat16)
    q80 = q80.reshape(qkv.shape)
    ref = int8_block.attention_i8_reference(q80, heads, hd, a, sd)
    assert agrees(k1(q=q80), ref)
    assert not agrees(k1(), ref)


# the int8 GEMM (csrc/int8_gemm_sm90.cu; chip_smoke.py phase 2i): (M, K, N)
# at its tile edges (ragged M, N % 256 == 128, a 64-deep K tail)
_I8_SHAPES = [(300, 768, 1152), (2049, 832, 2304), (2049, 1152, 4352)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", _I8_SHAPES)
def test_int8_gemm_matches_twin_on_card(shape, mode):
    """The launch in each mode: the int32 mode bit-equal to torch._int_mm;
    the others against the twin's epilogue on those sums, at most 1e-5 of
    the outputs not bit-equal and none more than a bf16 step (one code)
    apart, the sum of out^2 within rtol 1e-4 of its own output's; a
    128-deep K slice skipped and the weight read with the wrong swizzle
    fail it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpudf_torch.ops.quant import quant_rows
    from tpudf_torch.utils.nn import gelu_tanh
    m, k, n = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(m + k + n + mode)
    codes = lambda *sh: torch.randint(-127, 128, sh, generator=g, device=dev,
                                      dtype=torch.int8)
    a8, wt = codes(m, k), codes(n, k)
    cs = torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-3
    bias = torch.randn(n, generator=g, device=dev) * 0.1
    act, act_out = (torch.tensor(v, device=dev) for v in (4.0, 3.0))
    res = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    ss = torch.zeros(m, device=dev)

    def run(a_, w_, sumsq=None):
        return int8_block.i8_gemm_cuda(
            a_, w_, cs, bias, act, mode, residual=res if mode == 2 else None,
            sumsq=sumsq, act_out=act_out if mode == 1 else None)

    acc = torch._int_mm(a8, wt.t())
    got = run(a8, wt, ss if mode == 2 else None)
    f = acc.float() * ((act / 127.0) * cs) + bias
    ref = [f.to(torch.bfloat16), quant_rows(gelu_tanh(f), act_out),
           (res.float() + f).to(torch.bfloat16), acc][mode]
    skip = a8.clone()
    skip[:, 128:256] = 0
    kw = k // 128 * 128
    idx = (torch.arange(8, device=dev)[None, :]
           ^ (torch.arange(n, device=dev)[:, None] % 8))
    swz = torch.cat([torch.gather(
        wt[:, :kw].reshape(n, k // 128, 8, 16), 2,
        idx[:, None, :, None].expand(n, k // 128, 8, 16)).reshape(n, kw),
        wt[:, kw:]], 1).contiguous()
    faults = [run(skip, wt), run(a8, swz)]
    torch.cuda.synchronize()
    if mode == 3:
        assert torch.equal(got, acc)
        assert not any(torch.equal(x, acc) for x in faults)
        return
    a, b = got.float(), ref.float()
    step = (torch.ones_like(a) if mode == 1 else torch.exp2(torch.floor(
        torch.log2(torch.maximum(a.abs(), b.abs()).clamp_min(1e-30))) - 7))
    assert bool(((a - b).abs() <= step).all())
    assert float((got != ref).float().mean()) <= 1e-5
    assert all(float((x != ref).float().mean()) > 1e-5 for x in faults)
    if mode == 2:
        own = (a * a).sum(-1)
        torch.testing.assert_close(ss, own, atol=0, rtol=1e-4)


# K5 on the int8 wgmma GEMM with its LN panel (chip_smoke.py phase 2k): (M,
# W, N) where blocks walk several row tiles (65536 rows), a ragged M, a
# 64-deep K tail and the widest panel
_K5_SHAPES = [(65536, 1152, 6144), (8 * 257, 1152, 6144), (2049, 832, 2304),
              (1000, 1280, 3840)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _K5_SHAPES)
def test_k5_matches_twin_on_card(shape):
    """K5 within atol 5e-2 + rtol 2e-2 of its twin, bit-equal to K8 + the
    int8 GEMM (kEpiBf16) and to itself over repeated launches, every column
    written into a pre-filled output; the twin with g dropped, a 128-deep
    panel slice zero or the act scale ignored, and (where blocks walk
    several row tiles) each block's later units computed from its first
    unit's rows, break the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, w, n = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(m + w)
    r = lambda *s, std=1.0: torch.randn(s, generator=g, device=dev) * std
    x = (r(m, w) * 3.0 + 0.5).to(torch.bfloat16)
    ln = {"scale": 1.0 + r(w, std=0.1), "bias": r(w, std=0.1)}
    wq = {"q": torch.randint(-127, 128, (w, n), generator=g, device=dev,
                             dtype=torch.int8),
          "scale": r(n).abs() * 1e-3 + 1e-3}
    wq["qT"] = quant.transposed(wq)
    bias, a = r(n, std=0.1), torch.tensor(4.0, device=dev)
    args = (x, ln, wq, bias, a)
    pre = torch.full((m, n), 7.0, dtype=torch.bfloat16, device=dev)
    got = int8_block.ln_qkv_int8(*args, out=pre)
    ref = int8_block.ln_qkv_reference(*args)
    two = int8_block.i8_gemm_cuda(layernorm.ln_quant_cuda(x, ln, a, 1e-6),
                                  wq["qT"], wq["scale"], bias, a, 0)

    def rel(out):
        return float(((out.float() - ref.float()).abs()
                      / (5e-2 + 2e-2 * ref.float().abs())).max())

    def from_codes(codes):
        acc = quant.int8_mm(codes, wq["q"])
        return (acc.float() * ((a / 127.0) * wq["scale"].float())
                + bias).to(torch.bfloat16)

    y = layernorm.ln_rows_f32(x, ln["scale"], ln["bias"], 1e-6)
    hole = quant.quant_rows(y, a)
    hole[:, w // 256 * 128:w // 256 * 128 + 128] = 0
    faults = [from_codes(hole), from_codes(quant.quant_rows(
        y, torch.tensor(1.0, device=dev))),
        int8_block.ln_qkv_reference(x, {"scale": torch.ones_like(
            ln["scale"]), "bias": ln["bias"]}, wq, bias, a)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    walk = int8_block.k5_units(m, n, sms)
    if any(len(blk) > 1 for blk in walk):
        stale = ref.clone()
        for blk in walk:
            r0 = blk[0][0]
            for rt, c0, c1 in blk[1:]:
                stale[rt * 128:(rt + 1) * 128, c0 * 128:c1 * 128] = \
                    ref[r0 * 128:(r0 + 1) * 128, c0 * 128:c1 * 128]
        faults.append(stale)
    torch.cuda.synchronize()
    assert rel(got) <= 1.0
    assert torch.equal(got, two)
    assert all(torch.equal(int8_block.ln_qkv_int8(*args), got)
               for _ in range(2))
    assert all(rel(f) > 1.0 for f in faults)


# 9b's pre-pass and int8 wgmma pass (chip_smoke.py phase 2k): (B, S, heads,
# head_dim) at heads of 64 and 128 and S = 576, 1024 and a ragged 1297
_9B_SM90 = [(4, 576, 8, 64), (2, 1024, 8, 128), (2, 1297, 4, 64),
            (2, 1297, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _9B_SM90)
def test_9b_wgmma_pass_matches_twin_on_card(case):
    """The pre-pass's codes bit-equal to `attention_i8_codes_reference`; the
    output, on q, k, v of std 1.5, with at most 1e-2 of its elements a bf16
    step from the twin's (9b's card rule), as the wrapper's; the same main
    pass on v8t in natural key order breaks the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, heads, hd = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(s + hd)
    qkv = (torch.randn((b, s, 3 * heads * hd), generator=g, device=dev)
           * 1.5).to(torch.bfloat16)
    qb, sp = min(256, s), attention.i8_pad(s)
    codes = attention.i8dyn_prepass(qkv, heads, hd, qb)
    got = attention.i8dyn_main(codes, b, s, heads, hd, qb, hd ** -0.5)
    ref = attention.attention_qkv_int8_reference(qkv, heads, hd)
    pos = torch.tensor([attention.vt_pos(x) for x in range(sp)], device=dev)
    amax, q8, k8, v8t = codes
    natural = attention.i8dyn_main((amax, q8, k8, v8t[..., pos].contiguous()),
                                   b, s, heads, hd, qb, hd ** -0.5)
    torch.cuda.synchronize()

    def share(out):
        a_, r_ = out.float(), ref.float()
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(
            a_.abs(), r_.abs()).clamp_min(1e-30))) - 7)
        return float(((a_ - r_).abs() > step).float().mean())

    plain = attention.attention_i8_codes_reference(qkv, heads, hd)
    assert all(torch.equal(x, y) for x, y in zip(codes, plain))
    assert torch.equal(attention.attention_qkv_int8(qkv, heads, hd), got)
    assert share(got) <= 1e-2
    assert share(natural) > 1e-2


# K6's cluster tile and K7's four phases on wgmma + TMA (chip_smoke.py
# phase 2l; its fault emulations): K6 at (B, S, heads, head_dim), W = Wa =
# heads head_dim; K7 at (B, S) of base-256's layer
_K6_SM90 = [(8, 256, 12, 64), (8, 576, 16, 64), (256, 32, 12, 64),
            (8, 576, 48, 16), (8, 584, 24, 32), (8, 576, 6, 128),
            (8, 584, 3, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", _K6_SM90,
                         ids=[f"{b}x{s}-{h}x{d}" for b, s, h, d in _K6_SM90])
def test_k6_matches_split_form_on_card(case):
    """K6 bit-equal to K1's attention launch + the int8 GEMM in
    GEMM_RESIDUAL mode and to itself over repeated launches, within atol
    5e-2 + rtol 2e-2 of its twin and ATTN_REL of the attention part, on q,
    k, v of std 1.5; its cluster size the wrapper's; one CTA's heads
    missing from the panels, the panel unswizzled, a weight tile skipped,
    the bias or the residual dropped, the scale x0.75 and (at a ragged S)
    the keys past S unmasked break the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.ops import _build
    b, s, heads, hd = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(s + hd)
    r = lambda *sh, std=1.0: torch.randn(sh, generator=g, device=dev) * std
    w = heads * hd
    tile, live = int8_block.k6_tile(hd)
    lib = _build.load()
    waves = {n: lib.tpudf_attn_out_waves(tile, w, n) for n in range(1, 9)}
    c = int8_block.k6_cluster(b, s, heads, tile, live, w, waves)
    assert lib.tpudf_attn_out_cluster(b, s, heads, tile, live, w) == c
    qkv = cs.sharp_qkv(r, b, s, heads, hd, hd)
    x = r(b, s, w).to(torch.bfloat16)
    wq = add_kernel_layout(quant.quantize_weight(r(w, w, std=w ** -0.5)))
    bias, a = r(w, std=0.1), torch.tensor(2.0, device=dev)
    args = (qkv, x, wq, bias, a, heads, hd)
    got = int8_block.attn_out_int8(*args)
    ref = int8_block.attn_out_reference(*args)
    o8 = int8_block.attention_i8(qkv, heads, hd, a)
    lost = o8.clone().reshape(b * s, heads, hd)
    lost[:, 1 % c::c] = 0
    skipped = cs.k6_split(*args)
    skipped[..., 128:256] = 0
    faults = [cs.k6_proj(lost.reshape(b * s, w), x, wq, bias, a),
              cs.k6_proj(cs.unswizzled(o8, s), x, wq, bias, a), skipped,
              cs.k6_proj(o8, x, wq, torch.zeros_like(bias), a),
              cs.k6_proj(o8, torch.zeros_like(x), wq, bias, a),
              cs.k6_split(*args, scale=0.75 * hd ** -0.5)]
    if s % 64:
        faults.append(cs.keys_unmasked(
            lambda q: cs.k6_split(q, torch.cat(
                [x, x[:, -1:].expand(b, -s % 64, -1)], 1), wq, bias, a,
                heads, hd), qkv))
    torch.cuda.synchronize()
    rel = cs.rel_part(x)
    assert torch.equal(got, cs.k6_split(*args))
    assert torch.equal(got, int8_block.attn_out_int8(*args))
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2,
                               rtol=2e-2)
    assert rel(got, ref) <= cs.ATTN_REL
    assert all(rel(f, ref) > cs.ATTN_REL for f in faults)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 256), (256, 32)])
def test_k7_matches_twin_on_card(shape):
    """K7 by its card rule (atol 5e-2 + rtol 2e-2, at most K7_SHARE of the
    outputs not bit-equal) against the twin on K8's LN1 codes (its first
    phase's), within the plain twin's element tolerance, and bit-equal over
    repeated launches; that twin with x1 rounded to bf16 between the
    phases, LN2 over x, GELU dropped or a phase-3 row tile started before
    its x1 rows were written breaks it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.convert import add_kernel_layout
    b, s = shape
    w, heads, hd, inter = 768, 12, 64, 3072
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(b + s)
    r = lambda *sh, std=1.0: torch.randn(sh, generator=g, device=dev) * std
    wq = lambda k, n: add_kernel_layout(quant.quantize_weight(
        r(k, n, std=k ** -0.5)))
    bp = {"ln1": {"scale": 1.0 + r(w, std=0.1), "bias": r(w, std=0.1)},
          "ln2": {"scale": 1.0 + r(w, std=0.1), "bias": r(w, std=0.1)},
          "attn": {"qkv_w": wq(w, 3 * w), "qkv_b": r(3 * w, std=0.1),
                   "out_w": wq(w, w), "out_b": r(w, std=0.1)},
          "mlp": {"fc1_w": wq(w, inter), "fc1_b": r(inter, std=0.1),
                  "fc2_w": wq(inter, w), "fc2_b": r(w, std=0.1)},
          "act_scales": {k: torch.tensor(v, device=dev) for k, v in
                         (("qkv", 4.0), ("out", 2.0), ("fc1", 4.0),
                          ("fc2", 3.0))}}
    x = r(b, s, w).to(torch.bfloat16)
    got = int8_block.siglip_layer_int8(x, bp, heads, hd)
    twin = int8_block.siglip_layer_int8_reference(x, bp, heads, hd)
    assert torch.equal(cs.k7_twin(x, bp, heads, hd), twin)
    q8 = layernorm.layer_norm_quant(x.reshape(-1, w), bp["ln1"]["scale"],
                                    bp["ln1"]["bias"], bp["act_scales"]["qkv"])
    ref = cs.k7_twin(x, bp, heads, hd, q8=q8)
    out_tol, share = cs.k7_rule(got, ref)
    assert out_tol == 0 and share <= cs.K7_SHARE
    assert cs.k7_rule(got, twin)[0] == 0
    assert torch.equal(int8_block.siglip_layer_int8(x, bp, heads, hd), got)
    for fault in ("x1 in bf16", "LN2 over x", "GELU dropped", "early start"):
        n, sh = cs.k7_rule(cs.k7_twin(x, bp, heads, hd, fault, q8), ref)
        assert n > 0 or sh > cs.K7_SHARE, fault


def _qc_rand(seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    return dev, lambda *sh, std=1.0: torch.randn(sh, generator=g,
                                                 device=dev) * std


def _qc_wq(r):
    from tpudf_torch.convert import add_kernel_layout
    return lambda k, n: add_kernel_layout(quant.quantize_weight(
        r(k, n, std=k ** -0.5)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 256, 18, 64, 1152),
                                  (2, 576, 8, 128, 1024)],
                         ids=["18x64-W1152", "S576-8x128-W1024"])
def test_k6_past_its_panel_runs_split_on_card(case):
    """Where JAX runs its K6 past K6_MAX_WA, the split route runs (its own
    launch count), bit-equal to K1's attention launch + the int8 GEMM and
    within phase 2b's rule of the twin; the route skipped (the residual
    alone) and the scale x0.75 fail by at least twice ATTN_REL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.core.backend import LAUNCHES
    b, s, heads, hd, w = case
    dev, r = _qc_rand(s + w)
    wa = heads * hd
    qkv = cs.sharp_qkv(r, b, s, heads, hd, hd)
    x = r(b, s, w).to(torch.bfloat16)
    wq, bias = _qc_wq(r)(wa, w), r(w, std=0.1)
    a = torch.tensor(2.0, device=dev)
    args = (qkv, x, wq, bias, a, heads, hd)
    LAUNCHES.reset()
    got = int8_block.attn_out_int8(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {int8_block.KERNEL_ATTN_OUT_SPLIT: 1}
    ref = int8_block.attn_out_reference(*args)
    assert torch.equal(got, cs.k6_split(*args))
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2,
                               rtol=2e-2)
    rel = cs.rel_part(x)
    assert rel(got, ref) <= cs.ATTN_REL
    assert rel(x, ref) >= 2 * cs.ATTN_REL
    assert rel(cs.k6_split(*args, scale=0.75 * hd ** -0.5), ref) >= (
        2 * cs.ATTN_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 64, 256, 2, 128, 512),
                                  (2, 64, 128, 8, 16, 256),
                                  (2, 576, 128, 2, 64, 256),
                                  (2, 64, 384, 1, 384, 512),
                                  (2, 64, 1408, 22, 64, 128)],
                         ids=["2x128", "8x16", "S576", "1x384-split",
                              "W1408-split"])
def test_k7_on_jax_decision_matches_twin_on_card(case):
    """K7 where JAX's whole-layer kernel runs, by the form `k7_form` names
    (the one-launch kernel on K6's tiles, or its split form), by phase
    2l's rule against the twin on K8's LN1 codes, within the plain twin's
    element tolerance, bit-equal over launches; its twin with x1 rounded
    to bf16 (the split form's planted fault), LN2 over x or GELU dropped
    fails by at least twice the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.core.backend import LAUNCHES
    b, s, w, heads, hd, inter = case
    dev, r = _qc_rand(w + s + hd)
    bp = cs.k7_tree(r, _qc_wq(r), w, inter, dev)
    x = r(b, s, w).to(torch.bfloat16)
    assert int8_block.layer_int8_eligible(x, bp, heads, hd)
    name = (int8_block.KERNEL_LAYER
            if int8_block.k7_form(s, w, heads, hd) == "one"
            else int8_block.KERNEL_LAYER_SPLIT)
    LAUNCHES.reset()
    got = int8_block.siglip_layer_int8(x, bp, heads, hd)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == {name: 1}
    twin = int8_block.siglip_layer_int8_reference(x, bp, heads, hd)
    q8 = layernorm.layer_norm_quant(x.reshape(-1, w), bp["ln1"]["scale"],
                                    bp["ln1"]["bias"], bp["act_scales"]["qkv"])
    ref = cs.k7_twin(x, bp, heads, hd, q8=q8)
    out_tol, share = cs.k7_rule(got, ref)
    assert out_tol == 0 and share <= cs.K7_SHARE
    assert cs.k7_rule(got, twin)[0] == 0
    assert torch.equal(int8_block.siglip_layer_int8(x, bp, heads, hd), got)
    for fault in ("x1 in bf16", "LN2 over x", "GELU dropped"):
        bad = cs.k7_twin(x, bp, heads, hd, fault, q8)
        assert max(cs.k7_rule(bad, ref)[1] / cs.K7_SHARE,
                   cs.fails_by(bad, ref, 5e-2, 2e-2)) >= 2.0, fault


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1408, 1536, 4096])
def test_rows_past_1280_match_twins_on_card(w):
    """K4 within one bf16 step of its twin, K8's codes and the f32 row
    pass's at most K8_SHARE apart (by one), at widths past the register
    row; the row's second half dropped from the statistics fails by at
    least twice; K5 past its panel is K8 + the int8 GEMM bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from tpudf_torch.core.backend import LAUNCHES
    from tpudf_torch.ops.quant import transposed
    dev, r = _qc_rand(w)
    x = (r(512, w) * 3.0 + 0.5).to(torch.bfloat16)
    gm, bt = 1.0 + r(w, std=0.1), r(w, std=0.1)
    a = torch.tensor(3.0, device=dev)
    got = layernorm.layer_norm_fused(x, gm, bt)
    ref = layernorm.layer_norm_reference(x, gm, bt)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                               rtol=2 ** -7)
    half = cs.ln_half_stats(x, gm, bt)
    assert cs.fails_by(got, half.to(torch.bfloat16), 1e-6, 2 ** -7) >= 2
    want = layernorm.layer_norm_quant_reference(x, gm, bt, a)
    x32 = r(512, w) * 3.0 + 0.5
    for codes, ref_codes in (
            (layernorm.layer_norm_quant(x, gm, bt, a), want),
            (layernorm.ln_quant_f32_cuda(x32, {"scale": gm, "bias": bt}, a,
                                         1e-6),
             layernorm.layer_norm_quant_reference(x32, gm, bt, a))):
        d = (codes.int() - ref_codes.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= (
            cs.K8_SHARE)
    assert float((quant.quant_rows(half, a) != want).float().mean()) >= (
        2 * cs.K8_SHARE)
    if w < 4096:
        ln = {"scale": gm, "bias": bt}
        wq, bias = _qc_wq(r)(w, 3 * w), r(3 * w, std=0.1)
        LAUNCHES.reset()
        qkv = int8_block.ln_qkv_int8(x, ln, wq, bias, a)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == {int8_block.KERNEL_LN_QKV_SPLIT: 1}
        pair = int8_block.i8_gemm_cuda(
            layernorm.layer_norm_quant(x, gm, bt, a), transposed(wq),
            wq["scale"], bias, a, int8_block.GEMM_BF16)
        assert torch.equal(qkv, pair)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 64])
def test_k3_strips_match_twin_on_card(b):
    """K3 on its strips within atol 1e-6 / rtol 1e-4 of the twin and
    bit-identical over three launches; the halo rows zeroed, a strip's
    partial missing or a clamped border fail by at least twice that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(b)
    gray = torch.rand((b, 256, 256), generator=g, device=dev)
    got = [srm.srm_raw_moments(gray) for _ in range(3)]
    ref = srm.srm_raw_moments_reference(gray)
    torch.testing.assert_close(got[0], ref, atol=1e-6, rtol=1e-4)
    assert all(torch.equal(got[0], o) for o in got[1:])
    for fault in ("halo rows zeroed", "a strip's partial missing",
                  "clamped border"):
        assert cs.fails_by(got[0], cs.k3_fault(gray, fault), 1e-6,
                           1e-4) >= 2, fault
