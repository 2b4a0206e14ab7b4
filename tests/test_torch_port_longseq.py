"""The attention kernels past 1024 tokens (ROADMAP Queue C 1): K9, K1, K6
and 9b take every S that JAX's routes send to its Pallas kernels, and
their twins equal JAX there, on the CPU.

  (a) the domain  JAX's own decisions at S = 1296 (a patch-16 tower at
      576 px) and S = 2304 (768 px), read by tracing its wrappers with
      jax.eval_shape and pl.pallas_call stubbed (tests/test_torch_port_
      large.py's way), at base-256's width (heads of 64) and so400m's
      padded width (16 heads of 128): wherever JAX runs `attention_qkv`'s
      kernel (K9, and 9b with int8_attn), `attn_sublayer_int8`'s (K1) or
      `attn_out_int8`'s (K6), the port's predicate for that kernel
      (`check_attention_shape` and `sm90_fwd_fits`;
      `check_attn_sublayer_int8`; `check_attn_out_int8`) takes the same
      shape; and the wrappers' limits hold at MAX_SEQ and refuse past it
  (b) the twins at S = 1296, W = 128 (2 heads of 64, or 1 head of 128
      with 72 live dims and scale 72^-0.5), on numpy inputs from a seed:
      K9's twin against `_reference_qkv` in f32 with and without the ToMe
      bias within 2e-3, and against `_attention_qkv_pallas(interpret=
      True)` in bf16 within atol 1e-2 + rtol 2^-7; K1's twin against
      `attn_sublayer_int8(interpret=True)` with the bias within 5e-2; K6's
      against `attn_out_int8(interpret=True)` within 2e-3; 9b's against
      `_attention_qkv_pallas(interpret=True, int8_attn=True)` within one
      bf16 step but in rows with a probability code at a tie (<= 1 % of
      rows): tests/test_torch_port_large.py's tolerances at S = 576. At
      S = 1296 9b's int32 p8 . v8 sums pass 2^24 in flat rows; the twin
      rounds them once to f32 as JAX does
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_large import (_bf16_step, _jax_takes, _no_kernel,
                                         _p8_ties, _qkv)
from tests.test_torch_port_variants import (  # noqa: F401
    _compile, _np, _qw, _t, _tree_t, _vec, persist_every_compile)
from tpudf.ops import attention as J_attn
from tpudf.ops import int8_block as J_int8
from tpudf.ops.attention import _attention_qkv_pallas, _reference_qkv
from tpudf_torch.ops import attention, int8_block

S_LONG = (1296, 2304)
# W, heads, head_dim: base-256, and so400m-512's heads padded to 128
GEOMETRIES = {"base-256": (768, 12, 64), "so400m-padded": (2048, 16, 128)}


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


# ------------------------------------------------------------ (a) domain

def _port_takes(check, *args):
    try:
        check(*args)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("s", S_LONG)
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_port_takes_every_long_sequence_jax_sends_to_pallas(name, s,
                                                            monkeypatch):
    w, heads, d = GEOMETRIES[name]
    wa = heads * d
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
    # K9 and 9b: JAX routes attention_qkv on lane alignment alone
    for int8_attn in (False, True):
        jax_k9 = takes(J_attn, "_reference_qkv", lambda q:
                       J_attn.attention_qkv(q, heads, d, interpret=True,
                                            int8_attn=int8_attn),
                       sds(b, s, 3 * wa))
        assert jax_k9, (name, s, int8_attn)
        assert _port_takes(attention.check_attention_shape, "K9", qkv,
                           heads, d)
        assert attention.sm90_fwd_fits(s, wa, d)
    # K1: where JAX's fit takes its fused sublayer
    jax_k1 = takes(J_int8, "ln_qkv_int8", lambda v, g, a, ab, o, ob, c:
                   J_int8.attn_sublayer_int8(v, g, a, ab, o, ob, c, c,
                                             heads, d, interpret=True),
                   sds(b, s, w), ln, wq(w, 3 * wa), vec(3 * wa), wq(wa, w),
                   vec(w), one)
    assert jax_k1 == int8_block.attn_sublayer_int8_fits(b, s, w, wa, d)
    port_wq = lambda a, c: {"q": meta(a, c, dt=torch.int8)}
    if jax_k1:
        assert _port_takes(int8_block.check_attn_sublayer_int8,
                           meta(b, s, w), port_wq(w, 3 * wa),
                           port_wq(wa, w), heads, d)
    # K6: where JAX's fit takes its fused attention + out-projection
    jax_k6 = takes(J_int8, "_attn_out_reference", lambda q, v, o, ob, c:
                   J_int8.attn_out_int8(q, v, o, ob, c, heads, d,
                                        interpret=True),
                   sds(b, s, 3 * wa), sds(b, s, w), wq(wa, w), vec(w), one)
    assert jax_k6 == int8_block.attn_out_int8_fits(s, wa, w, d)
    if jax_k6:
        assert _port_takes(int8_block.check_attn_out_int8, qkv,
                           meta(b, s, w), port_wq(wa, w), heads, d)
    # base-256 at 576 px takes both fused kernels; at 768 px JAX's fits
    # send K1 and K6 to their split and reference routes
    if name == "base-256":
        assert (jax_k1, jax_k6) == ((True, True) if s == 1296
                                    else (False, False))


def test_limits_hold_at_max_seq_and_refuse_past_it():
    meta = lambda *sh: torch.empty(sh, dtype=torch.bfloat16, device="meta")
    top = attention.MAX_SEQ
    attention.check_attention_shape("K9", meta(1, top, 3 * 128), 2, 64)
    assert attention.sm90_fwd_fits(top, 128, 64)
    assert not attention.sm90_fwd_fits(top + 1, 128, 64)
    with pytest.raises(ValueError):
        attention.check_attention_shape("K9", meta(1, top + 1, 384), 2, 64)
    # the rows B·S of a call stay within an int
    rows = attention.MAX_ROWS // 1296 + 1
    with pytest.raises(ValueError):
        attention.check_attention_shape("K9", meta(rows, 1296, 384), 2, 64)
    # 9b's int32 sums of p8 · v8 (at most 127² S) do not overflow
    assert 127 * 127 * top < 2 ** 31


def test_kernel_limit_is_the_wrappers():
    """csrc/common.cuh's kMaxSeq and kMaxRows are the wrapper's MAX_SEQ and
    MAX_ROWS."""
    import re
    from tpudf_torch.ops._build import CSRC
    src = (CSRC / "common.cuh").read_text()
    seq = re.search(r"kMaxSeq = 1 << (\d+);", src)
    rows = re.search(r"kMaxRows = (\d+)ll;", src)
    assert 1 << int(seq.group(1)) == attention.MAX_SEQ
    assert int(rows.group(1)) == attention.MAX_ROWS


# ------------------------------------------------------------ (b) twins

S = 1296
_HEADS = [(2, 64, 64), (1, 128, 72)]     # heads, head_dim, live dims


@pytest.mark.parametrize("heads,hd,live", _HEADS)
def test_k9_twin_matches_jax_reference_f32_with_bias(heads, hd, live):
    rng = np.random.default_rng(90 + hd)
    qkv = rng.normal(0, 1.5, (1, S, 3 * heads * hd)).astype(np.float32)
    lb = np.log(rng.integers(1, 9, (1, S))).astype(np.float32)
    scale = live ** -0.5
    for bias in (None, lb):
        want = _reference_qkv(jnp.asarray(qkv), heads, hd, scale,
                              None if bias is None else jnp.asarray(bias))
        got = attention.attention_qkv(
            _t(qkv), heads, hd, scale,
            logit_bias=None if bias is None else _t(bias))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("heads,hd,live", _HEADS)
def test_k9_twin_matches_pallas_interpret_at_1296(heads, hd, live):
    qkv = _qkv(np.random.default_rng(91), 1, S, heads, hd, live)
    scale = live ** -0.5
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, scale, interpret=True), jq)(jq), np.float32)
    got = _np(attention.attention_qkv(_t(qkv).to(torch.bfloat16), heads, hd,
                                      scale))
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("heads,hd,live", _HEADS)
def test_k1_twin_matches_pallas_interpret_at_1296(heads, hd, live):
    rng = np.random.default_rng(92)
    w, wa = 128, heads * hd
    x = rng.normal(0, 1, (1, S, w)).astype(np.float32)
    ln = {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)}
    qkv_wq, qkv_b = _qw(rng, w, 3 * wa), _vec(rng, 3 * wa)
    out_wq, out_b = _qw(rng, wa, w), _vec(rng, w)
    if live < hd:                   # prepad_siglip_static's zero columns
        qkv_wq["q"].reshape(w, 3, heads, hd)[..., live:] = 0
        qkv_b.reshape(3, heads, hd)[..., live:] = 0
        out_wq["q"].reshape(heads, hd, w)[:, live:] = 0
    scale = live ** -0.5
    lb = np.log(rng.integers(1, 5, (1, S))).astype(np.float32)
    jt = lambda t: {k: jnp.asarray(a) for k, a in t.items()}
    want = np.asarray(_compile(lambda v, b_: J_int8.attn_sublayer_int8(
        v, jt(ln), jt(qkv_wq), jnp.asarray(qkv_b), jt(out_wq),
        jnp.asarray(out_b), 3.0, 2.0, heads, hd, 1e-6, scale, logit_bias=b_,
        interpret=True), x, lb)(x, lb))
    got = int8_block.attn_sublayer_int8(
        _t(x), _tree_t(ln), _tree_t(qkv_wq), _t(qkv_b), _tree_t(out_wq),
        _t(out_b), torch.tensor(3.0), torch.tensor(2.0), heads, hd, 1e-6,
        scale, logit_bias=_t(lb))
    np.testing.assert_allclose(_np(got), want, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("heads,hd,live", _HEADS)
def test_k6_twin_matches_pallas_interpret_at_1296(heads, hd, live):
    rng = np.random.default_rng(93)
    w, wa = 128, heads * hd
    qkv = _qkv(rng, 1, S, heads, hd, live) * 2.0
    x = rng.normal(0, 1, (1, S, w)).astype(np.float32)
    wq, bias = _qw(rng, wa, w), _vec(rng, w)
    scale = live ** -0.5
    assert int8_block.attn_out_int8_fits(S, wa, w, hd)   # JAX's kernel
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, {k: jnp.asarray(a) for k, a in wq.items()}, jnp.asarray(bias),
        2.0, heads, hd, scale, interpret=True), qkv, x)(qkv, x))
    got = int8_block.attn_out_int8(_t(qkv), _t(x), _tree_t(wq), _t(bias),
                                   torch.tensor(2.0), heads, hd, scale)
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("heads,hd,live", _HEADS)
def test_9b_twin_matches_pallas_interpret_at_1296(heads, hd, live):
    b = 1
    qkv = _qkv(np.random.default_rng(94), b, S, heads, hd, live)
    scale = live ** -0.5
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, scale, interpret=True, int8_attn=True), jq)(jq),
        np.float32)
    got = _np(attention.attention_qkv_int8(
        _t(qkv).to(torch.bfloat16), heads, hd, scale))
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(b, S, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(qkv, heads, hd, scale)).any()
    assert bad.mean() <= 0.01


def test_9b_twin_rounds_long_int32_sums_once():
    """At S = 1296 a flat row's p8 · v8 sums pass 2^24 (127² S in all):
    the twin sums them exactly and rounds once to f32, as JAX converts its
    int32 dot, so in f32 the two agree bit for bit."""
    heads, hd = 2, 64
    w = heads * hd
    qkv = np.zeros((1, S, 3 * w), np.float32)    # q = k = 0: p = 1 / S
    qkv[..., 2 * w:] = 1.0                       # v codes 127 ...
    qkv[0, 1::2, 2 * w:] = np.float32(125 / 127)   # ... and 125
    got = attention.attention_qkv_int8(_t(qkv), heads, hd)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, hd ** -0.5, interpret=True, int8_attn=True),
        qkv)(qkv))
    assert 127 * 127 * S > 2 ** 24
    np.testing.assert_array_equal(_np(got), want)
