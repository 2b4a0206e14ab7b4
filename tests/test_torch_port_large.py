"""Parity of the port with the JAX package at the large backbones' shapes
(large-384: S = 576, heads of 64; so400m-512: S = 1024, heads of 72 padded
to 128 with scale 72^-0.5, MLP 4304 padded to 4352, width 1152), on the
CPU. Inputs are made with numpy from a seed and handed to both packages;
JAX runs its Pallas kernels in interpret mode under
jax_default_matmul_precision=highest. Tolerances:
  9b  twin vs `_attention_qkv_pallas(interpret=True, int8_attn=True)`,
      bf16, (2, 576, 2 heads of 64) (the third 256-row query block is
      padded) and (1, 1024, 1 head of 128, 72 of its dims live): within one
      bf16 step, except in rows where a probability code p·127/ap lies
      within 1e-3 of a rounding tie (exp and the row sum round apart in
      the two frameworks, and such a code may flip; at most 1 % of the
      rows depart)
  K9  twin vs `_attention_qkv_pallas(interpret=True)`, bf16, S = 576 at
      heads of 64 and of 128: atol 1e-2 + rtol 2^-7 (f32 sums in another
      order before one bf16 rounding)
  K6  twin vs `attn_out_int8(interpret=True)`, f32, S = 576 at heads of
      64 and of 128: 2e-3, JAX's own tolerance (the twin quantises the
      attention output the Pallas kernel keeps in f32)
  K1  twin vs `attn_sublayer_int8(interpret=True)`, f32, S = 576 at heads
      of 64 and of 128 (scale 72^-0.5): 5e-2 (as PR 1's K1 test: the
      kernel quantises the f32 attention output, int8 ties)
  tower  `siglip_forward` at SigLIPConfig(128, 2, 2, 256, 384, 16) (S =
      576), static W8A8, bf16, 2 images, under FPP, PPP, XXX and LLL,
      without and with ToMe at the deployed schedule (r = 96, floor 72:
      576 -> 480): tokens 0.125, pooled 0.075, pooled cosine >= 0.999 (PR
      4's tolerances); with ToMe, near-ties of the matching scores swap a
      few of the 96 merges (at least 97 % of each image's sizes equal),
      and an image with a swapped merge is held through pooled alone. At this narrow width JAX's whole-layer kernel fits,
      and its LLL runs it; the port's K7 takes S <= 256 only, so its LLL
      runs FPP (the difference is the mid-layer residual's rounding)
  so400m  one so400m-512 layer at full width on a 64 px image (S = 16):
      the port's quantize_siglip_static (with prepad_siglip_static) equals
      JAX's bit for bit and crosses convert.py both ways, and the layer's
      output through FPP and PPP is within 5e-2 of JAX's interpret run
  routing  JAX's own decisions, read by tracing its wrappers with
      jax.eval_shape at full width (8 images, every ToMe token count),
      equal the port's predicates; TPUDF_INT8_ATTN changes the port's
      output only on the reference route without a bias
  ToMe  merge_schedule, the deployed floors and merge_step at 576 and 1024
      tokens equal JAX's (sizes exact, tokens 1e-5)
  pipeline  resizes to and from 384 px, the 384 px patch grid: 1e-5
Each JAX graph is traced in a fresh thread and compiled without LLVM's
optimisation passes (tests/test_torch_port_variants.py's `_compile`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import (  # noqa: F401
    numpy_params, one_torch_thread)
from tests.test_torch_port_variants import (  # noqa: F401
    _compile, _np, _qw, _t, _tree_t, _vec, persist_every_compile)
from tpudf.core.precision import DEFAULT_POLICY as J_POLICY
from tpudf.data import pipeline as J_pipe
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import SigLIPConfig as JConfig
from tpudf.models.siglip import _block_apply as j_block_apply
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.models.siglip import map_head as j_map_head
from tpudf.models.siglip import siglip_forward as j_siglip
from tpudf.ops import int8_block as J_int8
from tpudf.ops import mlp as J_mlp
from tpudf.ops import quant as J_quant
from tpudf.ops import tome as J_tome
from tpudf.ops.attention import _attention_qkv_pallas
from tpudf_torch.convert import params_from_numpy, params_to_numpy
from tpudf_torch.data import pipeline as P
from tpudf_torch.models.siglip import (CONFIGS, SigLIPConfig, _block_apply,
                                       layer_slice, siglip_forward)
from tpudf_torch.ops import attention, int8_block, quant, tome

TOWER = (128, 2, 2, 256, 384, 16)   # width, layers, heads, MLP, image, patch
ROUTES = ["FPP", "PPP", "XXX", "LLL"]
_ROUTE_ATOL = {"tokens": 0.125, "pooled": 0.075}


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


def _bf16(a):
    """a rounded to bf16, as the f32 values both sides read."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _bf16_step(v):
    """The spacing of bf16 values at magnitude v (one step)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(v, 1e-30))) - 7)


def _qkv(rng, b, s, heads, hd, live):
    """(B, S, 3·heads·hd) bf16 values, N(0, 0.5²) in the first `live` dims
    of each head and zero in the rest (prepad_siglip_static's padding)."""
    qkv = rng.normal(0, 0.5, (b, s, 3, heads, hd)).astype(np.float32)
    qkv[..., live:] = 0.0
    return _bf16(qkv.reshape(b, s, -1))


# ---------------------------------------------------------------- 9b

def _p8_ties(qkv, heads, hd, scale):
    """(B, S, heads): whether a row's probability code p·127/ap before
    rounding lies within 1e-3 of a tie for any key, from `_one_head`'s
    formulas (in f32, as the twin computes them)."""
    t = torch.from_numpy(qkv)
    b, s, _ = t.shape
    w = heads * hd
    qb = min(256, s)
    sp = -(-s // qb) * qb
    q, k = (t[..., i * w:(i + 1) * w].reshape(b, s, heads, hd)
            .transpose(1, 2) for i in range(2))
    qp = torch.nn.functional.pad(q, (0, 0, 0, sp - s)).reshape(
        b, heads, sp // qb, qb, hd)
    aq = torch.amax(qp.abs(), dim=(-2, -1), keepdim=True) + 1e-6
    q8 = torch.clamp(torch.round(qp * (127.0 / aq)), -127, 127).reshape(
        b, heads, sp, hd)[:, :, :s]
    aq = torch.repeat_interleave(aq.reshape(b, heads, -1), qb,
                                 dim=-1)[..., :s, None]
    ak = torch.amax(k.abs(), dim=(-2, -1), keepdim=True) + 1e-6
    k8 = torch.clamp(torch.round(k * (127.0 / ak)), -127, 127)
    sc = (q8 @ k8.transpose(-1, -2)) * ((aq * ak) / (127.0 * 127.0) * scale)
    p = torch.softmax(sc, dim=-1)
    pre = p * (127.0 / (p.amax(-1, keepdim=True) + 1e-20))
    frac = pre - torch.floor(pre)
    return ((frac - 0.5).abs() < 1e-3).any(-1).transpose(1, 2).numpy()


@pytest.mark.parametrize("b,s,heads,hd,live", [(2, 576, 2, 64, 64),
                                               (1, 1024, 1, 128, 72)])
def test_9b_twin_matches_pallas_interpret(b, s, heads, hd, live):
    qkv = _qkv(np.random.default_rng(s), b, s, heads, hd, live)
    scale = live ** -0.5
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, scale, interpret=True, int8_attn=True), jq)(jq),
        np.float32)
    got = _np(attention.attention_qkv_int8(
        _t(qkv).to(torch.bfloat16), heads, hd, scale))
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(b, s, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(qkv, heads, hd, scale)).any()
    assert bad.mean() <= 0.01


# ---------------------------------------------------------------- K9, K6, K1

@pytest.mark.parametrize("heads,hd,live", [(2, 64, 64), (1, 128, 72)])
def test_k9_twin_matches_pallas_interpret_long(heads, hd, live):
    qkv = _qkv(np.random.default_rng(3), 2, 576, heads, hd, live)
    scale = live ** -0.5
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, scale, interpret=True), jq)(jq), np.float32)
    got = _np(attention.attention_qkv(_t(qkv).to(torch.bfloat16), heads, hd,
                                      scale))
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("heads,hd,live", [(2, 64, 64), (1, 128, 72)])
def test_k6_twin_matches_pallas_interpret_long(heads, hd, live):
    rng = np.random.default_rng(4)
    w, wa = 128, heads * hd
    qkv = _qkv(rng, 2, 576, heads, hd, live) * 2.0
    x = rng.normal(0, 1, (2, 576, w)).astype(np.float32)
    wq, bias = _qw(rng, wa, w), _vec(rng, w)
    scale = live ** -0.5
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, {k: jnp.asarray(a) for k, a in wq.items()}, jnp.asarray(bias),
        2.0, heads, hd, scale, interpret=True), qkv, x)(qkv, x))
    got = int8_block.attn_out_int8(_t(qkv), _t(x), _tree_t(wq), _t(bias),
                                   torch.tensor(2.0), heads, hd, scale)
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("heads,hd,live", [(2, 64, 64), (1, 128, 72)])
def test_k1_twin_matches_pallas_interpret_long(heads, hd, live):
    rng = np.random.default_rng(5)
    w, wa = 128, heads * hd
    x = rng.normal(0, 1, (2, 576, w)).astype(np.float32)
    ln = {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)}
    qkv_wq, qkv_b = _qw(rng, w, 3 * wa), _vec(rng, 3 * wa)
    out_wq, out_b = _qw(rng, wa, w), _vec(rng, w)
    if live < hd:                   # prepad_siglip_static's zero columns
        qkv_wq["q"].reshape(w, 3, heads, hd)[..., live:] = 0
        qkv_b.reshape(3, heads, hd)[..., live:] = 0
        out_wq["q"].reshape(heads, hd, w)[:, live:] = 0
    scale = live ** -0.5
    lb = np.log(rng.integers(1, 5, (2, 576))).astype(np.float32)
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


# ---------------------------------------------------------------- tower

_TOWER = {}


def _tower_setup():
    """Seeded numpy parameters of the S = 576 test tower, calibrated and
    quantised (static W8A8) by the port; both sides read this tree."""
    if "params" not in _TOWER:
        cfg = SigLIPConfig(*TOWER)
        floats = numpy_params(
            lambda: j_init_siglip(jax.random.key(0), JConfig(*TOWER)), 0)
        px = np.random.default_rng(1).uniform(
            -1, 1, (2, 384, 384, 3)).astype(np.float32)
        tp = params_from_numpy(floats, "cpu")
        q = quant.quantize_siglip_static(
            tp, quant.calibrate_siglip_act_scales(tp, cfg, _t(px)), cfg)
        _TOWER["params"] = params_to_numpy(q)
        _TOWER["px"] = px
    return _TOWER["params"], _TOWER["px"]


def _jax_towers(monkeypatch):
    """JAX's tokens, pooled and sizes under every route, without and with
    ToMe, from one graph (JAX reads the route while it traces); the towers
    run headless and `map_head` once per ToMe setting over the stacked
    tokens, as tests/test_torch_port_variants.py does."""
    if "routes" not in _TOWER:
        params, px = _tower_setup()
        jcfg = JConfig(*TOWER)
        headless = dataclasses.replace(jcfg, with_head=False)
        floor = J_tome.deployed_floor(576)

        def every_route(p, x):
            out = {}
            for r in (0, J_tome.DEPLOYED_TOME_R):
                runs = []
                for route in ROUTES:
                    monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
                    runs.append(j_siglip(p, x, headless, tome_r=r,
                                         tome_floor=floor, interpret=True))
                tokens = jnp.concatenate([o["tokens"] for o in runs])
                bias = (jnp.log(jnp.concatenate([o["sizes"] for o in runs]))
                        if r else None)
                pooled = j_map_head(tokens, p["head"], jcfg, J_POLICY,
                                    interpret=True, logit_bias=bias)
                n = len(px)
                for i, (route, o) in enumerate(zip(ROUTES, runs)):
                    out[f"{route}{r}"] = (o["tokens"],
                                          pooled[i * n:(i + 1) * n],
                                          o.get("sizes"))
            return out

        _TOWER["routes"] = _compile(every_route, params, px)(params, px)
    return _TOWER["routes"]


@pytest.mark.parametrize("tome_r", [0, 96])
@pytest.mark.parametrize("route", ROUTES)
def test_tower_route_matches_jax_at_576_tokens(route, tome_r, monkeypatch):
    want = _jax_towers(monkeypatch)[f"{route}{tome_r}"]
    params, px = _tower_setup()
    monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
    got = siglip_forward(params_from_numpy(params, "cpu"), _t(px),
                         SigLIPConfig(*TOWER), tome_r=tome_r,
                         tome_floor=tome.deployed_floor(576))
    tokens, pooled, sizes = want
    # ToMe at 576 tokens: 96 of 288 candidate pairs merge, so a near-tie of
    # the matching scores (moved by the rounding above) swaps a few merges
    # (measured: 2 to 4 pairs, 4 to 8 of an image's 480 sizes, on every
    # route); such an image's tokens no longer line up position by
    # position and are held through pooled, the others by the tolerances
    same = np.ones(len(px), bool)
    if sizes is not None:
        assert got["tokens"].shape[1] == 480
        eq = got["sizes"].numpy() == np.asarray(sizes)
        assert eq.mean(-1).min() >= 0.97, (route, eq.mean(-1))
        same = eq.all(-1)
    for key, w in (("tokens", tokens), ("pooled", pooled)):
        assert got[key].dtype == torch.bfloat16
        keep = same if key == "tokens" else np.ones(len(px), bool)
        np.testing.assert_allclose(_np(got[key])[keep],
                                   np.asarray(w, np.float32)[keep],
                                   atol=_ROUTE_ATOL[key], rtol=0,
                                   err_msg=f"{route} {key}")
    a, b = _np(got["pooled"]), np.asarray(pooled, np.float32)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b,
                                                                        axis=-1)
    assert cos.min() >= 0.999, (route, cos)


# ---------------------------------------------------------------- so400m

def test_so400m_layer_matches_jax_at_full_width(monkeypatch):
    """One so400m-512 layer (W 1152, 16 heads of 72, MLP 4304) on a 64 px
    image: the port's calibrated, quantised and pre-padded tree equals
    JAX's quantize_siglip_static of the same floats and scales, and the
    block's output under FPP (K1, K2) and PPP (K5, K6, K2) matches JAX."""
    jcfg = dataclasses.replace(J_CONFIGS["so400m-512"], layers=1,
                               image_size=64, with_head=False)
    cfg = dataclasses.replace(CONFIGS["so400m-512"], layers=1, image_size=64,
                              with_head=False)
    floats = numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg), 6)
    px = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    tp = params_from_numpy(floats, "cpu")
    scales = quant.calibrate_siglip_act_scales(tp, cfg, _t(px))
    mine = params_to_numpy(quant.quantize_siglip_static(tp, scales, cfg))
    jtree = jax.tree.map(np.asarray, J_quant.quantize_siglip_static(
        floats, {k: np.asarray(v) for k, v in scales.items()}, jcfg))
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    mine_flat = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert len(flat) == len(mine_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(mine_flat[path], leaf, err_msg=path)
    # JAX's padded and unpadded trees cross convert.py both ways unchanged
    unpadded = jax.tree.map(np.asarray, J_quant.quantize_siglip_static(
        floats, {k: np.asarray(v) for k, v in scales.items()}))
    for tree in (jtree, unpadded):
        back = dict(jax.tree_util.tree_flatten_with_path(
            params_to_numpy(params_from_numpy(tree, "cpu")))[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    blocks = mine["blocks"]
    assert blocks["attn"]["qkv_w"]["q"].shape == (1, 1152, 3 * 16 * 128)
    assert blocks["mlp"]["fc1_w"]["q"].shape == (1, 1152, 4352)

    x = _bf16(np.random.default_rng(3).normal(0, 1, (2, 16, 1152)))
    bp_np = jax.tree.map(lambda a: a[0], blocks)
    bp = layer_slice(params_from_numpy(mine, "cpu")["blocks"], 0)
    for route in ("FPP", "PPP"):
        monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
        jx = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(_compile(lambda v, p: j_block_apply(
            v, p, jcfg, J_POLICY, True), jx, bp_np)(jx, bp_np), np.float32)
        got = _block_apply(_t(x).to(torch.bfloat16), bp, cfg)
        np.testing.assert_allclose(_np(got), want, atol=5e-2, rtol=0,
                                   err_msg=route)


# ---------------------------------------------------------------- routing

_GEOMETRIES = {     # W, heads, head_dim after padding, MLP after padding
    "base-256": (768, 12, 64, 3072),
    "large-384": (1024, 16, 64, 4096),
    "so400m-512": (1152, 16, 128, 4352),
}


def _no_kernel(kernel, out_shape, **_):
    """pl.pallas_call without its kernel: zeros of the output's shape (the
    decisions are taken before the call; tracing the kernel costs
    seconds)."""
    return lambda *args: jax.tree.map(lambda o: jnp.zeros(o.shape, o.dtype),
                                      out_shape)


def _jax_takes(monkeypatch, module, fallback, fn):
    """Whether tracing fn (a JAX wrapper with interpret=True under
    jax.eval_shape) avoids `module.fallback`, JAX's non-kernel route."""
    called = []
    orig = getattr(module, fallback)
    monkeypatch.setattr(module, fallback,
                        lambda *a, **k: called.append(1) or orig(*a, **k))
    out = fn()
    monkeypatch.setattr(module, fallback, orig)
    return not called and out is not None


@pytest.mark.parametrize("name", list(_GEOMETRIES))
def test_routing_predicates_match_jax(name, monkeypatch):
    monkeypatch.setattr(J_int8.pl, "pallas_call", _no_kernel)
    w, heads, d, inter = _GEOMETRIES[name]
    wa = heads * d
    n = CONFIGS[name].num_patches
    sds = lambda *s, dt=jnp.bfloat16: jax.ShapeDtypeStruct(s, dt)
    wq = lambda a, c: {"q": sds(a, c, dt=jnp.int8),
                       "scale": sds(c, dt=jnp.float32)}
    vec = lambda c: sds(c, dt=jnp.float32)
    ln = {"scale": vec(w), "bias": vec(w)}
    counts = {n}
    for r, floor in ((96, tome.deployed_floor(n)),
                     (128, tome.deployed_patch_floor(n))):
        t = n
        for ri in tome.merge_schedule(n, CONFIGS[name].layers, r, floor):
            t -= ri
            counts.add(t)
    mq = {"fc1_w": wq(w, inter), "fc1_b": vec(inter),
          "fc2_w": wq(inter, w), "fc2_b": vec(w)}
    one = sds(dt=jnp.float32)

    def takes(module, fallback, fn, *args):
        return _jax_takes(monkeypatch, module, fallback,
                          lambda: jax.eval_shape(fn, *args))

    for s in sorted(counts):
        x = sds(8, s, w)
        k1 = takes(J_int8, "ln_qkv_int8", lambda v, g, a, ab, o, ob, c:
                   J_int8.attn_sublayer_int8(v, g, a, ab, o, ob, c, c, heads,
                                             d, interpret=True),
                   x, ln, wq(w, 3 * wa), vec(3 * wa), wq(wa, w), vec(w), one)
        assert k1 == int8_block.attn_sublayer_int8_fits(8, s, w, wa, d), s
        k6 = takes(J_int8, "_attn_out_reference", lambda q, v, o, ob, c:
                   J_int8.attn_out_int8(q, v, o, ob, c, heads, d,
                                        interpret=True),
                   sds(8, s, 3 * wa), x, wq(wa, w), vec(w), one)
        assert k6 == int8_block.attn_out_int8_fits(s, wa, w, d), s
        if s == n:      # JAX's reference route at so400m-512's 1024
            assert k6 == (name != "so400m-512"), s
        # K5 and K2 fit at every width the port serves, as it assumes
        assert takes(J_int8, "_ln_qkv_reference", lambda v, g, a, ab, c:
                     J_int8.ln_qkv_int8(v, g, a, ab, c, interpret=True),
                     x, ln, wq(w, 3 * wa), vec(3 * wa), one)
        assert takes(J_mlp, "_reference_int8", lambda v, g, m, c:
                     J_mlp.mlp_block_fused_int8(
                         v, g, m, {"fc1": c, "fc2": c}, interpret=True),
                     x, ln, mq, one)
    # the whole layer: JAX's 13 MB fit, the port's K7 limits
    s = n
    meta = lambda *shape: torch.empty(shape, device="meta")
    bp = {"attn": {"qkv_w": {"q": meta(w, 3 * wa)},
                   "out_w": {"q": meta(wa, w)}},
          "mlp": {"fc1_w": {"q": meta(w, inter)}}}
    jbp = {"ln1": ln, "ln2": ln,
           "attn": {"qkv_w": wq(w, 3 * wa), "qkv_b": vec(3 * wa),
                    "out_w": wq(wa, w), "out_b": vec(w)},
           "mlp": mq,
           "act_scales": {k: one for k in ("qkv", "out", "fc1", "fc2")}}
    k7 = jax.eval_shape(lambda v, p: J_int8.siglip_layer_int8(
        v, p, heads, d, interpret=True), sds(8, s, w), jbp) is not None
    eligible = int8_block.layer_int8_eligible(meta(8, s, w), bp, heads, d)
    # JAX's K7 fits none of the three at full width (base-256 needs 14.0
    # MB), and the port's decision is JAX's
    assert not k7
    assert eligible == k7


def test_int8_attn_changes_only_the_biasless_reference_route(monkeypatch):
    """TPUDF_INT8_ATTN=1 moves `attn_out_int8` only where JAX reads it:
    the reference route (here S % 8 != 0, as JAX's predicate says) without
    a logit bias; K6's route and biased calls keep the bf16 attention."""
    rng = np.random.default_rng(6)
    w, heads, hd = 128, 2, 64
    wq, bias = _tree_t(_qw(rng, w, w)), _t(_vec(rng, w))
    outs = {}
    for s in (64, 60):
        qkv = _t(_bf16(rng.normal(0, 0.5, (2, s, 3 * w))))
        x = _t(_bf16(rng.normal(0, 1, (2, s, w))))
        lb = _t(np.log(rng.integers(1, 5, (2, s))).astype(np.float32))
        for env in ("0", "1"):
            monkeypatch.setenv("TPUDF_INT8_ATTN", env)
            for b_ in (None, lb):
                outs[s, env, b_ is None] = int8_block.attn_out_int8(
                    qkv, x, wq, bias, torch.tensor(0.5), heads, hd,
                    logit_bias=b_)
    assert int8_block.attn_out_int8_fits(64, w, w, hd)
    assert not int8_block.attn_out_int8_fits(60, w, w, hd)
    for s, biasless in ((64, True), (64, False), (60, False)):
        assert torch.equal(outs[s, "0", biasless], outs[s, "1", biasless])
    assert not torch.equal(outs[60, "0", True], outs[60, "1", True])


# ---------------------------------------------------------------- ToMe

@pytest.mark.parametrize("n,layers", [(576, 24), (1024, 27)])
def test_tome_schedules_and_merge_match_jax(n, layers):
    for r, floor_fn, j_floor_fn in (
            (tome.DEPLOYED_TOME_R, tome.deployed_floor, J_tome.deployed_floor),
            (tome.DEPLOYED_PATCH_TOME_R, tome.deployed_patch_floor,
             J_tome.deployed_patch_floor)):
        floor = floor_fn(n)
        assert floor == j_floor_fn(n)
        sched = tome.merge_schedule(n, layers, r, floor)
        assert sched == J_tome.merge_schedule(n, layers, r, floor)
        assert all(c % 8 == 0 for c in np.cumsum((n,) + tuple(-np.array(
            sched))))
    main = tome.merge_schedule(n, layers, 96, tome.deployed_floor(n))
    counts = n - np.cumsum(main)
    want = ([480, 384, 288, 192, 96, 72] if n == 576 else
            [928, 832, 736, 640, 544, 448, 352, 256, 160, 128])
    assert list(counts[:len(want)]) == want and counts[-1] == want[-1]
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, (2, n, 32)).astype(np.float32)
    sizes = rng.integers(1, 5, (2, n)).astype(np.float32)
    jx, js = jax.jit(J_tome.merge_step, static_argnums=2)(x, sizes, 96)
    tx, ts = tome.merge_step(_t(x), _t(sizes), 96)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------- pipeline

def test_pipeline_at_384_matches_jax():
    """The resizes the large-384 engine runs: a 512 px image to 384
    (bicubic, antialiased), 384 px views to the frequency expert's 256
    (bilinear), and the 384 px patch grid (96 px tiles upscaled 4x)."""
    x = np.random.default_rng(7).random((1, 512, 512, 3)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    x384 = J_pipe.preprocess_for_siglip(jx, 384)
    np.testing.assert_allclose(_np(P.preprocess_for_siglip(tx, 384)),
                               np.asarray(x384), atol=1e-5, rtol=0)
    t384 = torch.from_numpy(np.array(x384))
    np.testing.assert_allclose(_np(P.resize_bilinear(t384, 256)),
                               np.asarray(J_pipe.resize_bilinear(x384, 256)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(P.make_patch_grid(t384, 4)),
                               np.asarray(J_pipe.make_patch_grid(x384, 4)),
                               atol=1e-5, rtol=0)
