"""K1's attention on wgmma and TMA (tpudf_torch/csrc/attention_sm90.cu,
`int8_block.attention_i8`): a numpy model of the kernel's order against
JAX's K1 in Pallas interpret mode and against the port's twin, on the CPU.

  (a) the model  `k1_tile_model` computes what the kernel computes in its
      order, on kernels 11 and 12's softmax sequence: scores carrying log2
      e, (q . k) * (scale log2 e) (+ bias log2 e) in f32 over 64-key tiles
      (the keys past S at -inf); pass 1 the row max and sum of 2^(s - m)
      online, each of a row's four threads summing its 16 keys of a tile
      (keys 8 j + 2 t + e, j then e) and rescaling at a new max, the four
      partial sums added pairwise at the end; pass 2 p = 2^(s - m) (1 / l)
      in f32 (the exact softmax), rounded to bf16, o += p . v in f32 tile
      by tile; o quantised to int8 with 127 / act rounded half to even. A tile `width` columns
      wide reads each head's first `width` columns: so400m's heads of 72,
      padded to 128 with zero columns, run 80 wide and leave codes 0 in
      columns 80-127.
  (b) the sublayer  the model's codes through the out-projection and the
      residual, on qkv from the LN + QKV twin rounded to bf16 (the QKV
      GEMM's output), against `attn_sublayer_int8(..., interpret=True)` at
      S = 256 and 576, head_dim 64, 128, and 72 live of 128 (scale 72^-0.5,
      zero weight columns past 72), with and without the key bias (JAX with
      a zero bias), within K1's 5e-2; the model's codes against the twin's
      (`attention_i8_reference`, JAX's exact softmax: expf and a division),
      at most 1e-4 of them apart, each by one (the two sequences' p differ
      by a few f32 ulps, which can move p's bf16 rounding by a step).
  (c) `live`  the tile `i8_attn_tile` picks (80 of 128 at 65-80 live), the
      sublayer with live = 72 equal to the twin's, and a live width that
      does not fit its head refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_variants import (  # noqa: F401
    _compile, _np, _t, _tree_t, _vec, persist_every_compile)
from tpudf.ops import int8_block as J_int8
from tpudf_torch.ops import int8_block
from tpudf_torch.ops.quant import int8_mm

TILE = 64
LOG2E = np.float32(1.4426950408889634)
A_QKV, A_OUT = 3.0, 2.0


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


def _bf16(x):
    """f32 → the nearest bf16 (ties to even), as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(
        0xFFFF0000)
    return u.view(np.float32)


def _thread_order(tile):
    """(..., 64) keys of a tile → (..., 4, 16): thread t's 16 keys 8 j + 2 t
    + e in the order it adds them (j, then e)."""
    x = tile.reshape(*tile.shape[:-1], 8, 4, 2).swapaxes(-3, -2)
    return x.reshape(*tile.shape[:-1], 4, 16)


def k1_tile_model(qkv, heads, hd, scale, act, bias=None, width=None):
    """K1's attention kernel in its order: qkv (B, S, 3 heads hd) holding
    bf16 values → (B S, heads hd) int8 codes. width: the tile's columns
    (each head's first `width` read; the codes of the rest 0)."""
    width = width or hd
    b, s, w3 = qkv.shape
    w = w3 // 3
    parts = [qkv[..., i * w:(i + 1) * w].reshape(b, s, heads, hd)
             .transpose(0, 2, 1, 3)[..., :width].astype(np.float32)
             for i in range(3)]
    q, k, v = parts
    f32 = np.float32
    sc = np.matmul(q, k.swapaxes(-1, -2)).astype(f32) * (f32(scale) * LOG2E)
    if bias is not None:
        sc = sc + bias[:, None, None, :].astype(f32) * LOG2E
    n_t = -(-s // TILE)
    sc = np.pad(sc, ((0, 0), (0, 0), (0, 0), (0, n_t * TILE - s)),
                constant_values=-np.inf).astype(f32)
    m = np.full(sc.shape[:-1], -np.inf, f32)
    part = np.zeros((*sc.shape[:-1], 4), f32)
    with np.errstate(invalid="ignore"):
        for t in range(n_t):
            tile = _thread_order(sc[..., t * TILE:(t + 1) * TILE])
            tm = np.maximum(m, tile.max(axis=(-1, -2)))
            grow = (tm != m)[..., None]
            part = np.where(grow, part * np.exp2(m - tm)[..., None], part)
            m = tm
            for i in range(16):
                part = part + np.exp2(tile[..., i] - m[..., None])
    l = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    r = f32(1.0) / l
    o = np.zeros((b, heads, s, width), f32)
    for t in range(n_t):
        p = np.exp2(sc[..., t * TILE:(t + 1) * TILE] - m[..., None]) * r[
            ..., None]
        vt = np.pad(v[..., t * TILE:(t + 1) * TILE, :],
                    ((0, 0), (0, 0), (0, TILE - v[..., t * TILE:(
                        t + 1) * TILE, :].shape[-2]), (0, 0)))
        o = o + np.matmul(_bf16(p.astype(f32)), vt).astype(f32)
    inv = f32(127.0) / f32(act)
    codes = np.clip(np.rint(o * inv), -127, 127)
    full = np.zeros((b, heads, s, hd), np.int8)
    full[..., :width] = codes.astype(np.int8)
    return full.transpose(0, 2, 1, 3).reshape(b * s, heads * hd)


def _layer(rng, heads, hd, live):
    """A W8A8 layer of W = Wa = heads hd; at live < hd each head's qkv
    weight columns, bias and out-projection rows past `live` are zero (the
    pre-padded static tree)."""
    w = wa = heads * hd
    qkv_w = rng.normal(0, 1.5 * w ** -0.5, (w, 3, heads, hd))
    qkv_w[..., live:] = 0
    qkv_b = rng.normal(0, 0.1, (3, heads, hd))
    qkv_b[..., live:] = 0
    out_w = rng.normal(0, wa ** -0.5, (heads, hd, w))
    out_w[:, live:] = 0
    wq = lambda a: {k: v.numpy() for k, v in int8_block_quant(
        a.astype(np.float32)).items()}
    return {"ln": {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)},
            "qkv_wq": wq(qkv_w.reshape(w, 3 * wa)),
            "qkv_b": qkv_b.reshape(-1).astype(np.float32),
            "out_wq": wq(out_w.reshape(wa, w)), "out_b": _vec(rng, w)}


def int8_block_quant(a):
    from tpudf_torch.ops.quant import quantize_weight
    return quantize_weight(torch.from_numpy(a))


def _jt(tree):
    return {k: jnp.asarray(a) for k, a in tree.items()}


# (S, heads, head_dim, live): W = 128
CASES = [(256, 2, 64, 64), (256, 1, 128, 128), (256, 1, 128, 72),
         (576, 2, 64, 64), (576, 1, 128, 128), (576, 1, 128, 72)]


@pytest.mark.parametrize("s,heads,hd,live", CASES,
                         ids=[f"S{s}-{h}x{d}-live{lv}" for s, h, d, lv in
                              CASES])
def test_k1_tile_model_matches_pallas_interpret(s, heads, hd, live):
    rng = np.random.default_rng(200 + s + live)
    p = _layer(rng, heads, hd, live)
    w = heads * hd
    scale = live ** -0.5
    width = int8_block.i8_attn_tile(hd, None if live == hd else live)[0]
    x = _bf16(rng.normal(0, 1, (1, s, w)).astype(np.float32))
    lb = np.log(rng.integers(1, 9, (1, s))).astype(np.float32)
    jk1 = _compile(lambda v, b_: J_int8.attn_sublayer_int8(
        v, _jt(p["ln"]), _jt(p["qkv_wq"]), jnp.asarray(p["qkv_b"]),
        _jt(p["out_wq"]), jnp.asarray(p["out_b"]), A_QKV, A_OUT, heads, hd,
        1e-6, scale, logit_bias=b_, interpret=True), x, lb)
    xt = _t(x)
    qkv = _np(int8_block.ln_qkv_reference(
        xt, _tree_t(p["ln"]), _tree_t(p["qkv_wq"]), _t(p["qkv_b"]),
        torch.tensor(A_QKV)))
    qkv = _bf16(qkv)
    assert width == (80 if live == 72 else hd)
    wq = _tree_t(p["out_wq"])
    for bias in (None, lb):
        codes = k1_tile_model(qkv, heads, hd, scale, A_OUT, bias, width)
        if width < hd:
            assert not codes.reshape(s, heads, hd)[..., width:].any()
        # the model's codes through the out-projection and the residual
        acc = int8_mm(torch.from_numpy(codes), wq["q"]).reshape(1, s, w)
        proj = (acc.float() * ((A_OUT / 127.0) * wq["scale"].float())
                + _t(p["out_b"]))
        got = (xt + proj).numpy()
        want = np.asarray(jk1(x, np.zeros_like(lb) if bias is None
                              else bias))
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
        # against the twin's codes (the f32 o of the exact softmax quantised)
        twin = int8_block.attention_i8_reference(
            _t(qkv).to(torch.bfloat16), heads, hd, torch.tensor(A_OUT), scale,
            logit_bias=None if bias is None else _t(bias)).numpy()
        d = np.abs(codes.astype(np.int32) - twin)
        assert d.max() <= 1
        assert (d > 0).mean() <= 1e-4


def test_live_picks_the_80_wide_tile_and_refuses_what_does_not_fit():
    assert int8_block.i8_attn_tile(128, 72) == (80, 128)
    assert int8_block.i8_attn_tile(128, 80) == (80, 128)
    assert int8_block.i8_attn_tile(128, 100) == (128, 128)
    assert int8_block.i8_attn_tile(128) == (128, 128)
    assert int8_block.i8_attn_tile(32) == (64, 64)
    assert int8_block.i8_attn_tile(640) == (640, 640)
    for hd, live in ((128, 136), (128, 0), (64, 72), (16, 32)):
        with pytest.raises(ValueError):
            int8_block.i8_attn_tile(hd, live)
    rng = np.random.default_rng(7)
    heads, hd, s = 1, 128, 64
    p = _layer(rng, heads, hd, 72)
    x = _t(_bf16(rng.normal(0, 1, (1, s, heads * hd)).astype(np.float32)))
    args = (x, _tree_t(p["ln"]), _tree_t(p["qkv_wq"]), _t(p["qkv_b"]),
            _tree_t(p["out_wq"]), _t(p["out_b"]), torch.tensor(A_QKV),
            torch.tensor(A_OUT), heads, hd, 1e-6, 72 ** -0.5)
    lb = torch.log(torch.from_numpy(rng.integers(1, 9, (1, s)).astype(
        np.float32)))
    want = int8_block.attn_sublayer_reference(*args, logit_bias=lb)
    got = int8_block.attn_sublayer_int8(*args, logit_bias=lb, live=72)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        int8_block.attn_sublayer_int8(*args, live=136)
    meta = lambda *sh, dt=torch.bfloat16: torch.empty(sh, dtype=dt,
                                                      device="meta")
    wq = lambda a, c: {"q": meta(a, c, dt=torch.int8)}
    int8_block.check_attn_sublayer_int8(meta(1, s, 128), wq(128, 384),
                                        wq(128, 128), heads, hd, 72)
    with pytest.raises(ValueError):
        int8_block.check_attn_sublayer_int8(meta(1, s, 128), wq(128, 384),
                                            wq(128, 128), heads, hd, 129)
