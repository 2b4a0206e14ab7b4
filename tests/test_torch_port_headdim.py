"""Heads of 16, 32 and 256 (ROADMAP Queue C 1) and of 384 to 1280 (Queue C
2): K1, K6, K9, 9b and K10 take every head_dim JAX's lane rule (head_dim %
128 == 0 or 128 % head_dim == 0) sends to its Pallas kernels at W <= 1280,
and their twins equal JAX there, on the CPU.

  (a) the routes  JAX's own decisions, read by tracing its wrappers with
      jax.eval_shape and pl.pallas_call stubbed (tests/test_torch_port_
      large.py's way), at heads of 16 (8 heads, W = 128; 48, W = 768), 32
      (4 and 24 heads) and 256 (1 and 3 heads), S = 64, 200 and 576:
      wherever JAX runs `attention_qkv`'s kernel (K9, and 9b with
      int8_attn), its Pallas backward (K10), `attn_sublayer_int8`'s (K1) or
      `attn_out_int8`'s (K6), the port's routing copies decide the same and
      its checks (`check_attention_shape` and `sm90_fwd_fits`;
      `sm90_bwd_fits` and `check_attention_bwd_shape`;
      `check_attn_sublayer_int8`; `check_attn_out_int8`) admit the shape
  (b) the twins at S = 200 (a ragged key tile), W = 128 (W = 256 at heads
      of 256), on numpy inputs from a seed, against JAX's Pallas kernels in
      interpret mode: K9 and K10 within atol 1e-2 + rtol 2^-7 in bf16 (and
      2e-3 in f32 against `_reference_qkv` and its VJP), 9b within one
      bf16 step but in rows with a probability code at a tie (<= 1 % of
      rows), K1 within 5e-2, K6 within 2e-3 (PERF.md §6)
  (c) the padded route of K9, 9b and K10 at heads of 16 and 32: each
      head's columns zero-padded to 64 (`pad_heads`), the twin run at 64
      with the true head_dim's scale, the output sliced (`unpad_heads`),
      against JAX at the true head_dim with the same tolerances; K10's
      padded columns of dqkv are exactly 0 before the slice
  (d) the wide heads: JAX's routes as in (a) at 2 heads of 384 (W = 768),
      2 of 640 and 1 of 1280 (W = 1280), S = 64 and 200; HEAD_DIMS and
      BWD_HEAD_DIMS are the lane rule's whole set up to W = 1280; the twins
      of K9, 9b, K10, K1 and K6 at 2 x 384 and 1 x 1280, S = 64 (K1 and K6
      through a W8A8 layer), inside the kernels' domain, against JAX's
      Pallas interpret runs with (b)'s tolerances
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_k10 import _jax_calls_pallas_bwd
from tests.test_torch_port_large import (_bf16_step, _jax_takes, _no_kernel,
                                         _p8_ties)
from tests.test_torch_port_variants import (  # noqa: F401
    _compile, _np, _qw, _t, _tree_t, _vec, persist_every_compile)
from tpudf.ops import attention as J_attn
from tpudf.ops import int8_block as J_int8
from tpudf.ops.attention import (_attention_qkv_bwd_pallas,
                                 _attention_qkv_pallas, _reference_qkv)
from tpudf_torch.ops import attention, int8_block

BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
# (heads, head_dim) of the routes: W = 128 and W = 768 at heads of 16 and
# 32, W = 256 and 768 at heads of 256, and W = 768 at heads of 8 (JAX's
# rule takes every head_dim that divides 128)
ROUTE_HEADS = [(8, 16), (48, 16), (4, 32), (24, 32), (1, 256), (3, 256),
               (96, 8)]
ROUTE_S = (64, 200, 576)
# the wide heads (Queue C 2): (heads, head_dim) at W = 768 and 1280
WIDE_ROUTE_HEADS = [(2, 384), (2, 640), (1, 1280)]
WIDE_ROUTE_S = (64, 200)


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


def _port_takes(check, *args):
    try:
        check(*args)
        return True
    except ValueError:
        return False


# ------------------------------------------------------------ (a) routes

@pytest.mark.parametrize("s", ROUTE_S)
@pytest.mark.parametrize("heads,d", ROUTE_HEADS,
                         ids=[f"{h}x{d}" for h, d in ROUTE_HEADS])
def test_port_takes_every_head_jax_sends_to_pallas(heads, d, s, monkeypatch):
    _routes_agree(heads, d, s, monkeypatch)


@pytest.mark.parametrize("s", WIDE_ROUTE_S)
@pytest.mark.parametrize("heads,d", WIDE_ROUTE_HEADS,
                         ids=[f"{h}x{d}" for h, d in WIDE_ROUTE_HEADS])
def test_port_takes_wide_heads_jax_sends_to_pallas(heads, d, s,
                                                   monkeypatch):
    _routes_agree(heads, d, s, monkeypatch)


def _routes_agree(heads, d, s, monkeypatch):
    """Wherever JAX runs K9's, 9b's, K10's, K1's or K6's Pallas kernel at
    (heads, d, S), the port's routing copies decide the same and its checks
    admit the shape."""
    w = wa = heads * d
    monkeypatch.setattr(J_attn.pl, "pallas_call", _no_kernel)
    monkeypatch.setattr(J_int8.pl, "pallas_call", _no_kernel)
    sds = lambda *sh, dt=jnp.bfloat16: jax.ShapeDtypeStruct(sh, dt)
    wq = lambda a, c: {"q": sds(a, c, dt=jnp.int8),
                       "scale": sds(c, dt=jnp.float32)}
    vec = lambda c: sds(c, dt=jnp.float32)
    one = sds(dt=jnp.float32)
    ln = {"scale": vec(w), "bias": vec(w)}

    def takes(module, fallback, fn, *args):
        return _jax_takes(monkeypatch, module, fallback,
                          lambda: jax.eval_shape(fn, *args))

    b = 2
    meta = lambda *sh, dt=torch.bfloat16: torch.empty(sh, dtype=dt,
                                                      device="meta")
    qkv = meta(b, s, 3 * wa)
    # K9 and 9b: JAX routes attention_qkv on its lane rule alone
    for int8_attn in (False, True):
        assert takes(J_attn, "_reference_qkv", lambda q:
                     J_attn.attention_qkv(q, heads, d, interpret=True,
                                          int8_attn=int8_attn),
                     sds(b, s, 3 * wa)), int8_attn
        assert _port_takes(attention.check_attention_shape, "K9", qkv,
                           heads, d)
        assert attention.sm90_fwd_fits(s, wa, d)
    # K10: where JAX's custom VJP calls its Pallas backward
    jax_k10 = _jax_calls_pallas_bwd(monkeypatch, s, wa, d)
    assert jax_k10 == attention.attention_qkv_bwd_fits(s, wa, d)
    assert jax_k10                  # every case here fits JAX's 12 MiB
    assert attention.sm90_bwd_fits(s, wa, d)
    assert _port_takes(attention.check_attention_bwd_shape, "K10", qkv,
                       meta(b, s, wa), heads, d)
    # K1: where JAX's fit takes its fused sublayer
    jax_k1 = takes(J_int8, "ln_qkv_int8", lambda v, g, a, ab, o, ob, c:
                   J_int8.attn_sublayer_int8(v, g, a, ab, o, ob, c, c,
                                             heads, d, interpret=True),
                   sds(b, s, w), ln, wq(w, 3 * wa), vec(3 * wa), wq(wa, w),
                   vec(w), one)
    assert jax_k1 == int8_block.attn_sublayer_int8_fits(b, s, w, wa, d)
    assert jax_k1
    port_wq = lambda a, c: {"q": meta(a, c, dt=torch.int8)}
    assert _port_takes(int8_block.check_attn_sublayer_int8, meta(b, s, w),
                       port_wq(w, 3 * wa), port_wq(wa, w), heads, d)
    # K6: where JAX's fit takes its fused attention + out-projection
    jax_k6 = takes(J_int8, "_attn_out_reference", lambda q, v, o, ob, c:
                   J_int8.attn_out_int8(q, v, o, ob, c, heads, d,
                                        interpret=True),
                   sds(b, s, 3 * wa), sds(b, s, w), wq(wa, w), vec(w), one)
    assert jax_k6 == int8_block.attn_out_int8_fits(s, wa, w, d)
    assert jax_k6
    assert _port_takes(int8_block.check_attn_out_int8, qkv, meta(b, s, w),
                       port_wq(wa, w), heads, d)


def test_head_dims_are_jax_lane_rule_at_w_1280():
    """HEAD_DIMS (K1, K6, K9, 9b) and BWD_HEAD_DIMS (K10) are the head_dims
    up to W = 1280 that JAX's lane rule admits, the multiples of 128 past
    256 (ROADMAP Queue C 2) included: the checks take them, at one head of
    each and at W = 1280, and K10's dkv block fits its shared memory at
    the longest S of JAX's fit there."""
    lane = {d for d in range(1, 1281) if d % 128 == 0 or 128 % d == 0}
    assert set(attention.HEAD_DIMS) == lane
    assert set(attention.BWD_HEAD_DIMS) == lane
    assert set(attention.WIDE_HEAD_DIMS) == {d for d in lane if d > 256}
    meta = lambda *sh: torch.empty(sh, dtype=torch.bfloat16, device="meta")
    for d in sorted(attention.WIDE_HEAD_DIMS):
        heads = 1280 // d
        for h in {1, heads}:
            assert attention.sm90_fwd_fits(576, h * d, d)
            attention.check_attention_shape("K9", meta(1, 576, 3 * h * d),
                                            h, d)
            s = max(s for s in range(8, 2049, 8)
                    if attention.attention_qkv_bwd_fits(s, h * d, d))
            assert attention.sm90_bwd_fits(s, h * d, d), (h, d, s)
            assert (attention.sm90_dkv_smem(s, d)
                    <= attention.SM90_BLOCK_SMEM)
            attention.check_attention_bwd_shape(
                "K10", meta(1, s, 3 * h * d), meta(1, s, h * d), h, d)


# ------------------------------------------------------------ (b) twins

S = 200
TWIN_HEADS = [(8, 16), (4, 32), (1, 256)]
_IDS = [f"{h}x{d}" for h, d in TWIN_HEADS]


def _qkv(rng, s, heads, hd, std=1.5):
    return rng.normal(0, std, (1, s, 3 * heads * hd)).astype(np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _pallas_k9(qkv, heads, hd, int8_attn=False):
    jq = jnp.asarray(qkv, jnp.bfloat16)
    return np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, hd ** -0.5, interpret=True, int8_attn=int8_attn),
        jq)(jq), np.float32)


def _padded(fn, t, heads, hd, *more):
    """fn on each head zero-padded to 64 columns, sliced back: the route
    K9, 9b and K10 take on the card at heads of 16 and 32."""
    to = attention.PAD_HEAD_DIM
    out = fn(attention.pad_heads(t, heads, hd, to),
             *(attention.pad_heads(m, heads, hd, to) for m in more))
    return attention.unpad_heads(out, heads, hd, to)


@pytest.mark.parametrize("heads,hd", TWIN_HEADS, ids=_IDS)
def test_k9_twin_matches_jax(heads, hd):
    rng = np.random.default_rng(120 + hd)
    qkv = _qkv(rng, S, heads, hd)
    lb = np.log(rng.integers(1, 9, (1, S))).astype(np.float32)
    for bias in (None, lb):
        want = _reference_qkv(jnp.asarray(qkv), heads, hd, hd ** -0.5,
                              None if bias is None else jnp.asarray(bias))
        got = attention.attention_qkv(
            _t(qkv), heads, hd, logit_bias=None if bias is None else _t(bias))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                                   rtol=2e-3)
    want = _pallas_k9(qkv, heads, hd)
    bq = _t(qkv).to(torch.bfloat16)
    np.testing.assert_allclose(_np(attention.attention_qkv(bq, heads, hd)),
                               want, **BF16_STEP)
    if hd in attention.PADDED_HEAD_DIMS:
        got = _padded(lambda q: attention.attention_qkv_reference(
            q, heads, attention.PAD_HEAD_DIM, hd ** -0.5), bq, heads, hd)
        np.testing.assert_allclose(_np(got), want, **BF16_STEP)


@pytest.mark.parametrize("heads,hd", TWIN_HEADS, ids=_IDS)
def test_k10_twin_matches_jax(heads, hd):
    rng = np.random.default_rng(130 + hd)
    qkv = _bf16(_qkv(rng, S, heads, hd))
    g = _bf16(rng.standard_normal((1, S, heads * hd)).astype(np.float32))
    assert attention.attention_qkv_bwd_fits(S, heads * hd, hd)
    # f32: the function's gradient
    _, vjp = jax.vjp(lambda t: _reference_qkv(t, heads, hd, hd ** -0.5),
                     jnp.asarray(qkv))
    got = attention.attention_qkv_bwd(_t(qkv), _t(g), heads, hd)
    np.testing.assert_allclose(_np(got), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=2e-3, rtol=2e-3)
    # bf16: JAX's Pallas backward
    want = np.asarray(_attention_qkv_bwd_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), heads,
        hd, hd ** -0.5, interpret=True), np.float32)
    bq, bg = _t(qkv).to(torch.bfloat16), _t(g).to(torch.bfloat16)
    np.testing.assert_allclose(
        _np(attention.attention_qkv_bwd(bq, bg, heads, hd)), want,
        **BF16_STEP)
    if hd in attention.PADDED_HEAD_DIMS:
        to = attention.PAD_HEAD_DIM
        full = attention.attention_qkv_bwd_reference(
            attention.pad_heads(bq, heads, hd, to),
            attention.pad_heads(bg, heads, hd, to), heads, to, hd ** -0.5)
        pads = full.reshape(1, S, 3, heads, to)[..., hd:]
        assert torch.count_nonzero(pads) == 0
        got = attention.unpad_heads(full, heads, hd, to)
        np.testing.assert_allclose(_np(got), want, **BF16_STEP)


def _assert_9b_close(got, want, qkv, heads, hd):
    b = got.shape[0]
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(b, S, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(qkv, heads, hd, hd ** -0.5)).any()
    assert bad.mean() <= 0.01


@pytest.mark.parametrize("heads,hd", TWIN_HEADS, ids=_IDS)
def test_9b_twin_matches_pallas_interpret(heads, hd):
    qkv = _bf16(_qkv(np.random.default_rng(140 + hd), S, heads, hd, 0.5))
    want = _pallas_k9(qkv, heads, hd, int8_attn=True)
    bq = _t(qkv).to(torch.bfloat16)
    _assert_9b_close(_np(attention.attention_qkv_int8(bq, heads, hd)), want,
                     qkv, heads, hd)
    if hd in attention.PADDED_HEAD_DIMS:
        got = _padded(lambda q: attention.attention_qkv_int8_reference(
            q, heads, attention.PAD_HEAD_DIM, hd ** -0.5), bq, heads, hd)
        _assert_9b_close(_np(got), want, qkv, heads, hd)


def _int8_layer(rng, w, wa):
    return {"ln": {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)},
            "qkv_wq": _qw(rng, w, 3 * wa, std=1.5 * w ** -0.5),
            "qkv_b": _vec(rng, 3 * wa), "out_wq": _qw(rng, wa, w),
            "out_b": _vec(rng, w)}


def _jt(tree):
    return {k: jnp.asarray(a) for k, a in tree.items()}


@pytest.mark.parametrize("heads,hd", TWIN_HEADS, ids=_IDS)
def test_k1_twin_matches_pallas_interpret(heads, hd):
    rng = np.random.default_rng(150 + hd)
    w = wa = heads * hd
    p = _int8_layer(rng, w, wa)
    x = rng.normal(0, 1, (1, S, w)).astype(np.float32)
    lb = np.log(rng.integers(1, 5, (1, S))).astype(np.float32)
    want = np.asarray(_compile(lambda v, b_: J_int8.attn_sublayer_int8(
        v, _jt(p["ln"]), _jt(p["qkv_wq"]), jnp.asarray(p["qkv_b"]),
        _jt(p["out_wq"]), jnp.asarray(p["out_b"]), 3.0, 2.0, heads, hd,
        logit_bias=b_, interpret=True), x, lb)(x, lb))
    got = int8_block.attn_sublayer_int8(
        _t(x), _tree_t(p["ln"]), _tree_t(p["qkv_wq"]), _t(p["qkv_b"]),
        _tree_t(p["out_wq"]), _t(p["out_b"]), torch.tensor(3.0),
        torch.tensor(2.0), heads, hd, logit_bias=_t(lb))
    np.testing.assert_allclose(_np(got), want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("heads,hd", TWIN_HEADS, ids=_IDS)
def test_k6_twin_matches_pallas_interpret(heads, hd):
    rng = np.random.default_rng(160 + hd)
    w = wa = heads * hd
    qkv = _qkv(rng, S, heads, hd, 1.0)
    x = rng.normal(0, 1, (1, S, w)).astype(np.float32)
    wq, bias = _qw(rng, wa, w), _vec(rng, w)
    assert int8_block.attn_out_int8_fits(S, wa, w, hd)   # JAX's kernel
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, _jt(wq), jnp.asarray(bias), 2.0, heads, hd, interpret=True),
        qkv, x)(qkv, x))
    got = int8_block.attn_out_int8(_t(qkv), _t(x), _tree_t(wq), _t(bias),
                                   torch.tensor(2.0), heads, hd)
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=2e-3)


def test_pad_heads_round_trip_and_zero_columns():
    """pad_heads puts each head's columns first in a 64-wide slot of each
    part, zeros after them; unpad_heads inverts it. K9, 9b, K10 and K1's
    attention pad heads of 32 and fewer to 64; K6 pads those narrower than
    16 to 16; the rest run at their own width."""
    t = torch.arange(2 * 3 * 4 * 16, dtype=torch.float32).reshape(2, 192)
    p = attention.pad_heads(t, 4, 16, 64)
    assert p.shape == (2, 3 * 4 * 64)
    slots = p.reshape(2, 3, 4, 64)
    assert torch.equal(slots[..., :16], t.reshape(2, 3, 4, 16))
    assert torch.count_nonzero(slots[..., 16:]) == 0
    assert torch.equal(attention.unpad_heads(p, 4, 16, 64), t)
    wide = list(attention.WIDE_HEAD_DIMS)
    assert [attention.kernel_head_dim(d) for d in attention.HEAD_DIMS] == [
        64, 64, 64, 64, 64, 64, 64, 128, 256] + wide
    assert [int8_block.i8_attn_tile(d) for d in attention.HEAD_DIMS] == [
        (64, 64)] * 7 + [(128, 128), (256, 256)] + [(d, d) for d in wide]
    assert [int8_block.k6_head_dim(d) for d in attention.HEAD_DIMS] == [
        16, 16, 16, 16, 16, 32, 64, 128, 256] + wide


# ------------------------------------------------------------ (d) wide

WIDE_S = 64
WIDE_HEADS = [(2, 384), (1, 1280)]
_WIDE_IDS = [f"{h}x{d}" for h, d in WIDE_HEADS]


@pytest.mark.parametrize("heads,hd", WIDE_HEADS, ids=_WIDE_IDS)
def test_wide_head_k9_9b_k10_twins_match_jax(heads, hd):
    """K9 (± the key bias), 9b and K10 at a wide head: inside the kernels'
    domain, their twins against JAX's Pallas interpret runs."""
    s, w = WIDE_S, heads * hd
    rng = np.random.default_rng(170 + hd)
    qkv = _bf16(_qkv(rng, s, heads, hd))
    assert attention.sm90_fwd_fits(s, w, hd)
    bq = _t(qkv).to(torch.bfloat16)
    np.testing.assert_allclose(_np(attention.attention_qkv(bq, heads, hd)),
                               _pallas_k9(qkv, heads, hd), **BF16_STEP)
    lb = np.log(rng.integers(1, 9, (1, s))).astype(np.float32)
    np.testing.assert_allclose(
        _np(attention.attention_qkv(bq, heads, hd, logit_bias=_t(lb))),
        np.asarray(_reference_qkv(jnp.asarray(qkv, jnp.bfloat16), heads, hd,
                                  hd ** -0.5, jnp.asarray(lb)), np.float32),
        **BF16_STEP)
    q05 = _bf16(_qkv(rng, s, heads, hd, 0.5))
    got = _np(attention.attention_qkv_int8(_t(q05).to(torch.bfloat16),
                                           heads, hd))
    want = _pallas_k9(q05, heads, hd, int8_attn=True)
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(1, s, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(q05, heads, hd, hd ** -0.5)).any()
    assert bad.mean() <= 0.01
    g = _bf16(rng.standard_normal((1, s, w)).astype(np.float32))
    assert attention.attention_qkv_bwd_fits(s, w, hd)
    assert attention.sm90_bwd_fits(s, w, hd)
    want = np.asarray(_attention_qkv_bwd_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), heads,
        hd, hd ** -0.5, interpret=True), np.float32)
    np.testing.assert_allclose(
        _np(attention.attention_qkv_bwd(bq, _t(g).to(torch.bfloat16), heads,
                                        hd)), want, **BF16_STEP)


@pytest.mark.parametrize("heads,hd", WIDE_HEADS, ids=_WIDE_IDS)
def test_wide_head_k1_k6_twins_match_pallas_interpret(heads, hd):
    """K1 (with the key bias) and K6 through a W8A8 layer at a wide head:
    the port's checks admit the layer, its twins against JAX's Pallas
    interpret runs (K1 5e-2, K6 2e-3)."""
    s = WIDE_S
    rng = np.random.default_rng(180 + hd)
    w = wa = heads * hd
    p = _int8_layer(rng, w, wa)
    x = rng.normal(0, 1, (1, s, w)).astype(np.float32)
    lb = np.log(rng.integers(1, 5, (1, s))).astype(np.float32)
    meta = lambda *sh, dt=torch.bfloat16: torch.empty(sh, dtype=dt,
                                                      device="meta")
    port_wq = lambda a, c: {"q": meta(a, c, dt=torch.int8)}
    int8_block.check_attn_sublayer_int8(meta(1, s, w), port_wq(w, 3 * wa),
                                        port_wq(wa, w), heads, hd)
    want = np.asarray(_compile(lambda v, b_: J_int8.attn_sublayer_int8(
        v, _jt(p["ln"]), _jt(p["qkv_wq"]), jnp.asarray(p["qkv_b"]),
        _jt(p["out_wq"]), jnp.asarray(p["out_b"]), 3.0, 2.0, heads, hd,
        logit_bias=b_, interpret=True), x, lb)(x, lb))
    got = int8_block.attn_sublayer_int8(
        _t(x), _tree_t(p["ln"]), _tree_t(p["qkv_wq"]), _t(p["qkv_b"]),
        _tree_t(p["out_wq"]), _t(p["out_b"]), torch.tensor(3.0),
        torch.tensor(2.0), heads, hd, logit_bias=_t(lb))
    np.testing.assert_allclose(_np(got), want, atol=5e-2, rtol=5e-2)
    qkv = _qkv(rng, s, heads, hd, 1.0)
    wq, bias = _qw(rng, wa, w), _vec(rng, w)
    assert int8_block.attn_out_int8_fits(s, wa, w, hd)   # JAX's kernel
    int8_block.check_attn_out_int8(meta(1, s, 3 * wa), meta(1, s, w),
                                   port_wq(wa, w), heads, hd)
    assert int8_block.K6_MAX_WA[hd] is None             # two launches
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, _jt(wq), jnp.asarray(bias), 2.0, heads, hd, interpret=True),
        qkv, x)(qkv, x))
    got = int8_block.attn_out_int8(_t(qkv), _t(x), _tree_t(wq), _t(bias),
                                   torch.tensor(2.0), heads, hd)
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=2e-3)
