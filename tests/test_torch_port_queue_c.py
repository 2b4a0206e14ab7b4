"""The port's routes against JAX's own decisions where JAX's Pallas kernels
run: K6 past its panel, K7's decision and domain, rows wider than 1280
(ROADMAP Queue C 1-3), on the CPU. Inputs are made with numpy from a seed
and handed to both packages; JAX's decisions are read by tracing its
wrappers with jax.eval_shape (`pl.pallas_call` stubbed), its kernels run
in interpret mode under jax_default_matmul_precision=highest.

  K6 route  where JAX's `attn_out_int8` runs `_attn_out_kernel` but the o
      panel exceeds K6_MAX_WA (S 256: Wa 1152 with heads of 64, Wa 1024
      with heads of 128 and of 256, so400m's padded Wa 2048 with heads of
      128; S 576: Wa 1024 with heads of 128), `k6_route` is "split" and
      `check_attn_out_int8` takes the call: equal decisions
  K7 decision  `layer_int8_eligible` against JAX's `siglip_layer_int8`
      (`is not None`) at 13 geometries: equal; `k7_form` names the form
      that runs each on the card
  K7 twin  the port's LLL block against JAX's interpret-mode
      `_layer_kernel` at three geometries the port's old K7 did not take
      (W 256 with 2 heads of 128 at S 64, W 128 with 4 heads of 32 at S 64,
      W 128 with 2 heads of 64 at S 576): 2e-3 + rtol 2e-3 (PERF.md §6's
      K7 row) but at most 1e-3 of the elements, each within 5e-2 (a code
      of o, LN2 or the hidden at an int8 tie); rows with an LN1 code at an
      f32 tie left out (at most 1 %)
  widths  at W 1408 and 1536: K4's twin within one bf16 step of JAX's
      `_ln_kernel`; K8's codes equal except within 1e-3 of a rounding tie;
      K5's twin 1e-4; K1 + K2 through the FPP block 5e-2 (PERF.md §6); the
      card's row pass, K1's check and K5's split route take those widths
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_large import _jax_takes, _no_kernel
from tests.test_torch_port_variants import (  # noqa: F401
    _compile, _flipped_rows, _jax_ln_codes, _np, _qw, _t, _tree_t, _vec,
    persist_every_compile)
from tpudf.core.precision import DEFAULT_POLICY as J_POLICY
from tpudf.models.siglip import SigLIPConfig as JConfig
from tpudf.models.siglip import _block_apply as j_block_apply
from tpudf.ops import int8_block as J_int8
from tpudf.ops import layernorm as J_ln
from tpudf_torch.models.siglip import SigLIPConfig, _block_apply
from tpudf_torch.ops import int8_block, layernorm


@pytest.fixture(autouse=True, scope="module")
def highest_precision():
    key = "jax_default_matmul_precision"
    old = getattr(jax.config, key)
    jax.config.update(key, "highest")
    yield
    jax.config.update(key, old)


def _sds(*shape, dt=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dt)


def _jwq(a, c):
    return {"q": _sds(a, c, dt=jnp.int8), "scale": _sds(c, dt=jnp.float32)}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _raises(fn, *args):
    try:
        fn(*args)
        return False
    except ValueError:
        return True


# ------------------------------------------------------------ K6 (C 1)

# (S, heads, head_dim, W): JAX's fit holds, the o panel exceeds K6_MAX_WA
K6_PAST_PANEL = [(256, 18, 64, 1152), (256, 8, 128, 1024),
                 (256, 4, 256, 1024), (256, 16, 128, 1152),
                 (576, 8, 128, 1024)]


@pytest.mark.parametrize("s,heads,hd,w", K6_PAST_PANEL,
                         ids=[f"S{c[0]}-{c[1]}x{c[2]}-W{c[3]}"
                              for c in K6_PAST_PANEL])
def test_k6_routes_split_past_its_panel_where_jax_runs_its_kernel(
        s, heads, hd, w, monkeypatch):
    monkeypatch.setattr(J_int8.pl, "pallas_call", _no_kernel)
    wa = heads * hd
    jax_kernel = _jax_takes(
        monkeypatch, J_int8, "_attn_out_reference",
        lambda: jax.eval_shape(lambda q, v, o, ob, c: J_int8.attn_out_int8(
            q, v, o, ob, c, heads, hd, interpret=True),
            _sds(2, s, 3 * wa), _sds(2, s, w), _jwq(wa, w),
            _sds(w, dt=jnp.float32), _sds(dt=jnp.float32)))
    assert jax_kernel
    assert heads * int8_block.k6_head_dim(hd) > int8_block.K6_MAX_WA[hd]
    assert not _raises(int8_block.check_attn_out_int8, _meta(2, s, 3 * wa),
                       _meta(2, s, w), {"q": _meta(wa, w)}, heads, hd)
    assert int8_block.k6_route(s, heads, hd, w) == "split"
    assert int8_block.k6_route(s, heads, hd, w, logit_bias=True) == (
        "reference")


# ------------------------------------------------------------ K7 (C 2)

# (B, S, W, heads, head_dim, MLP, padded head slots): the three backbones
# at full width, the narrow and wide heads JAX's lane rule admits, S at
# and past the 13 MB fit, a width past the LN panel, a padded tree
K7_GEOMETRIES = {
    "base-256": (8, 256, 768, 12, 64, 3072, 0),
    "large-384": (8, 576, 1024, 16, 64, 4096, 0),
    "so400m-512": (8, 1024, 1152, 16, 128, 4352, 1),
    "W256-2x128-S64": (2, 64, 256, 2, 128, 512, 0),
    "W128-2x64-S576": (2, 576, 128, 2, 64, 256, 0),
    "W128-8x16": (2, 64, 128, 8, 16, 256, 0),
    "W128-4x32": (2, 64, 128, 4, 32, 256, 0),
    "W384-1x384": (2, 64, 384, 1, 384, 512, 0),
    "W1408-22x64": (2, 64, 1408, 22, 64, 128, 0),
    "W768-12x64-S240": (2, 240, 768, 12, 64, 3072, 0),
    "W768-12x64-S248": (2, 248, 768, 12, 64, 3072, 0),
    "W1152-18x64": (2, 64, 1152, 18, 64, 256, 0),
    "W128-16x8": (2, 64, 128, 16, 8, 256, 0),
}
# the form each runs on the card (None: JAX runs FPP there)
K7_FORM = {"base-256": None, "large-384": None, "so400m-512": None,
           "W256-2x128-S64": "one", "W128-2x64-S576": "one",
           "W128-8x16": "one", "W128-4x32": "one", "W384-1x384": "split",
           "W1408-22x64": "split", "W768-12x64-S240": "one",
           "W768-12x64-S248": None, "W1152-18x64": "split",
           "W128-16x8": "one"}


@pytest.mark.parametrize("name", list(K7_GEOMETRIES))
def test_k7_decision_is_jax(name, monkeypatch):
    monkeypatch.setattr(J_int8.pl, "pallas_call", _no_kernel)
    b, s, w, heads, hd, inter, padded = K7_GEOMETRIES[name]
    wa = heads * hd if padded else w
    vec = lambda c: _sds(c, dt=jnp.float32)
    ln = {"scale": vec(w), "bias": vec(w)}
    jbp = {"ln1": ln, "ln2": ln,
           "attn": {"qkv_w": _jwq(w, 3 * wa), "qkv_b": vec(3 * wa),
                    "out_w": _jwq(wa, w), "out_b": vec(w)},
           "mlp": {"fc1_w": _jwq(w, inter), "fc1_b": vec(inter),
                   "fc2_w": _jwq(inter, w), "fc2_b": vec(w)},
           "act_scales": {k: _sds(dt=jnp.float32)
                          for k in ("qkv", "out", "fc1", "fc2")}}
    k7 = jax.eval_shape(lambda v, p: J_int8.siglip_layer_int8(
        v, p, heads, hd, interpret=True), _sds(b, s, w), jbp) is not None
    bp = {"attn": {"qkv_w": {"q": _meta(w, 3 * wa)},
                   "out_w": {"q": _meta(wa, w)}},
          "mlp": {"fc1_w": {"q": _meta(w, inter)}}}
    x = _meta(b, s, w)
    assert int8_block.layer_int8_eligible(x, bp, heads, hd) == k7
    assert not int8_block.layer_int8_eligible(x, bp, heads, hd,
                                              torch.zeros(1))
    assert (int8_block.k7_form(s, w, heads, hd) if k7 else None) == (
        K7_FORM[name])


def test_k7_one_launch_fits_a_block_wherever_it_is_chosen():
    """Every geometry `k7_form` sends to the one-launch kernel has a
    layout (`k7_smem`, the C side's `layer_layout`) within 227 KB, its
    heads on K6's tile and panel."""
    for hd in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        for w in range(128, 1281, 128):
            heads = w // hd
            tile, live = int8_block.k6_tile(hd)
            smem = int8_block.k7_smem(w, heads * live, tile)
            if int8_block.k7_form(64, w, heads, hd) == "one":
                assert smem is not None and smem <= 232448, (hd, w)
                assert heads * live <= int8_block.K6_MAX_WA[live]
                assert w <= int8_block.K5_MAX_WIDTH
    assert int8_block.k7_smem(768, 768, 64) == 230640
    assert int8_block.k7_form(64, 384, 1, 384) == "split"
    assert int8_block.k7_form(64, 512, 2, 256) == "split"
    assert int8_block.k7_smem(768, 1536, 64) is None      # one stage


def _k7_tree(rng, w, inter):
    """A layer's static-W8A8 tree: weights of std fan_in^-0.5 (the init
    scale of the card's checks), seeded vectors and activation scales."""
    qw = lambda a, c: _qw(rng, a, c, std=a ** -0.5)
    return {"ln1": {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)},
            "ln2": {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)},
            "attn": {"qkv_w": qw(w, 3 * w), "qkv_b": _vec(rng, 3 * w),
                     "out_w": qw(w, w), "out_b": _vec(rng, w)},
            "mlp": {"fc1_w": qw(w, inter), "fc1_b": _vec(rng, inter),
                    "fc2_w": qw(inter, w), "fc2_b": _vec(rng, w)},
            "act_scales": {k: np.float32(v) for k, v in
                           (("qkv", 3.0), ("out", 2.0), ("fc1", 3.0),
                            ("fc2", 2.0))}}


@pytest.mark.parametrize("b,s,w,heads,hd,inter",
                         [(2, 64, 256, 2, 128, 256), (2, 64, 128, 4, 32, 256),
                          (1, 576, 128, 2, 64, 256)],
                         ids=["W256-2x128", "W128-4x32", "W128-2x64-S576"])
def test_k7_twin_matches_pallas_interpret_at_new_geometries(
        b, s, w, heads, hd, inter):
    rng = np.random.default_rng(11 + w + s)
    x = rng.normal(0, 1, (b, s, w)).astype(np.float32)
    bp = _k7_tree(rng, w, inter)
    jbp = jax.tree.map(jnp.asarray, bp)
    want = _compile(lambda v, p: J_int8.siglip_layer_int8(
        v, p, heads, hd, interpret=True), x, jbp)(x, jbp)
    assert want is not None
    tbp = _tree_t(bp)
    assert int8_block.layer_int8_eligible(_t(x), tbp, heads, hd)
    assert int8_block.k7_form(s, w, heads, hd) == "one"
    got = int8_block.siglip_layer_int8(_t(x), tbp, heads, hd)
    flipped = _flipped_rows(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                            3.0).reshape(b, s)
    assert flipped.mean() <= 0.01
    got, want = _np(got)[~flipped], np.asarray(want)[~flipped]
    outside = np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)
    # an int8 code of o, LN2 or the hidden at a rounding tie (f32 sums in
    # another order) moves its row past 2e-3: 5.8e-4 of the elements at S
    # 576, all within K1's 5e-2
    assert outside.mean() <= 1e-3
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


# ------------------------------------------------------- widths (C 3)

WIDTHS = [1408, 1536]


@pytest.mark.parametrize("w", WIDTHS + [4096])
def test_the_card_routes_take_rows_wider_than_1280(w):
    """The row pass (K4, K8, the LN pass of K1, K2, K13, K14) and K1's
    check take bf16 rows of these widths, the f32 pass (K7's split form)
    too; K5 past its panel runs as K8 + the int8 GEMM."""
    assert layernorm.MAX_WIDTH >= 4096 and layernorm.MAX_WIDTH_F32 >= 4096
    assert not _raises(layernorm._check_rows, _meta(4, w), "K4")
    assert not _raises(layernorm._check_rows,
                       _meta(4, w, dtype=torch.float32), "f32",
                       torch.float32)
    heads = w // 64
    assert not _raises(int8_block.check_attn_sublayer_int8, _meta(2, 16, w),
                       {"q": _meta(w, 3 * w)}, {"q": _meta(w, w)}, heads, 64)
    assert w > int8_block.K5_MAX_WIDTH
    assert int8_block.K5_MAX_WIDTH == layernorm.REG_WIDTH == 1280


@pytest.mark.parametrize("w", WIDTHS)
def test_k4_twin_matches_pallas_interpret_past_1280(w):
    rng = np.random.default_rng(w)
    jx = jnp.asarray(rng.normal(0.5, 3.0, (16, w)), jnp.bfloat16)
    g, b = _vec(rng, w, 1.0), _vec(rng, w)
    want = np.asarray(_compile(lambda v: J_ln.layer_norm_fused(
        v, jnp.asarray(g), jnp.asarray(b), interpret=True), jx)(jx),
        np.float32)
    got = _np(layernorm.layer_norm_fused(
        _t(np.asarray(jx, np.float32)).to(torch.bfloat16), _t(g), _t(b)))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step + 1e-6).all()


@pytest.mark.parametrize("w", WIDTHS)
def test_k8_codes_match_pallas_interpret_past_1280(w):
    rng = np.random.default_rng(w + 1)
    jx = jnp.asarray(rng.normal(0, 1, (16, w)), jnp.bfloat16)
    x = np.asarray(jx, np.float32)
    g, b = _vec(rng, w, 1.0), _vec(rng, w)
    want = np.asarray(_compile(lambda v: J_ln.layer_norm_quant(
        v, jnp.asarray(g), jnp.asarray(b), 3.0, interpret=True), jx)(jx))
    got = layernorm.layer_norm_quant(_t(x).to(torch.bfloat16), _t(g), _t(b),
                                     torch.tensor(3.0)).numpy()
    tie = np.asarray(_jax_ln_codes(x, g, b, np.float32(3.0))[1])
    diff = got != want
    assert not (diff & ~tie).any()
    assert diff.mean() < 1e-3


@pytest.mark.parametrize("w", WIDTHS)
def test_k5_twin_matches_pallas_interpret_past_1280(w):
    rng = np.random.default_rng(w + 2)
    n = 3 * w
    x = rng.normal(0, 1, (16, w)).astype(np.float32)
    jx = jnp.asarray(x)
    ln = {"scale": _vec(rng, w, 1.0), "bias": _vec(rng, w)}
    wq, bias = _qw(rng, w, n), _vec(rng, n)
    jln, jwq = jax.tree.map(jnp.asarray, ln), jax.tree.map(jnp.asarray, wq)
    want = np.asarray(_compile(lambda v: J_int8.ln_qkv_int8(
        v, jln, jwq, jnp.asarray(bias), 3.0, interpret=True), jx)(jx),
        np.float32)
    got = _np(int8_block.ln_qkv_int8(_t(x), _tree_t(ln), _tree_t(wq),
                                     _t(bias), torch.tensor(3.0)))
    rows = ~_flipped_rows(x, ln["scale"], ln["bias"], 3.0)
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("w", WIDTHS)
def test_fpp_block_matches_jax_past_1280(w, monkeypatch):
    """K1 + K2 through the port's FPP block against JAX's (interpret
    mode), heads of 64, MLP 512, 2 images of 16 tokens."""
    monkeypatch.setenv("TPUDF_INT8_KERNELS", "FPP")
    heads, inter = w // 64, 512
    rng = np.random.default_rng(w + 3)
    bp = _k7_tree(rng, w, inter)
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (2, 16, w)), jnp.bfloat16),
                   np.float32)
    jcfg = JConfig(w, 1, heads, inter, 64, 16, with_head=False)
    cfg = SigLIPConfig(w, 1, heads, inter, 64, 16, with_head=False)
    jbp = jax.tree.map(jnp.asarray, bp)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(_compile(lambda v, p: j_block_apply(
        v, p, jcfg, J_POLICY, True), jx, jbp)(jx, jbp), np.float32)
    got = _np(_block_apply(_t(x).to(torch.bfloat16), _tree_t(bp), cfg))
    assert int8_block.attn_sublayer_int8_fits(2, 16, w, w, 64)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)
