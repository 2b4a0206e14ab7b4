"""Parity of the W8A8 block's other routes with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
  K8  twin vs `layer_norm_quant(interpret=True)`, (4, 96, 128), f32 and
      bf16 rows: int8 codes equal except within 1e-3 of a rounding tie
  K5  twin vs `ln_qkv_int8(interpret=True)`, (2, 64, 128) → 384: within
      JAX's own 1e-4, except at rows whose LN codes flip at a tie (the f32
      LN statistics round differently in the last bit; at most 1 % of the
      rows; 0 of 128 flip on this seed, and the outputs are equal)
  K6  twin vs `attn_out_int8(interpret=True)`, (2, 64, 384) with and
      without a logit bias: 2e-3, JAX's own tolerance
  K7  twin vs `siglip_layer_int8(interpret=True)`, (2, 64, 128), MLP 256:
      2e-3 at f32, the same math (rows with a flipped LN1 code excepted, as
      K5; none flip on this seed, and the outputs are equal)
  tower  `siglip_forward` at SigLIPConfig(128, 2, 2, 256, 32, 8), W8A8
      static (one calibrated tree for both sides), default bf16 policy, 4
      images, under every distinct TPUDF_INT8_KERNELS route, without and
      with ToMe (r=8: 16 → 8 tokens after layer 0, so layer 1 takes the
      logit bias): tokens and pooled within `_ROUTE_ATOL`, pooled cosine
      >= 0.999; with ToMe, at most one image may merge other tokens than
      JAX's, and is then held by its pooled cosine alone, >= 0.98 (one of
      the 4 images re-merges on 7 of the 11 routes, cosine >= 0.991)
  dynamic  the dynamic-int8 block (quantize_siglip, no act_scales) at
      test-32, bf16: pooled within `_DYNAMIC_ATOL` (measured 0.031, two
      bf16 steps at |pooled| 3.7: bf16 elementwise rounding)
  weights  `quantize_siglip` equals JAX's bit for bit, and
      `convert.params_from_numpy` carries the dynamic-int8 tree both ways
Each JAX graph is traced in a fresh thread, compiled without LLVM's
optimisation passes and kept in the persistent compilation cache however
short its compile: it runs once.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import numpy_params, one_torch_thread  # noqa: F401
from tpudf.core.precision import DEFAULT_POLICY as J_POLICY
from tpudf.models.siglip import CONFIGS as J_CONFIGS
from tpudf.models.siglip import SigLIPConfig as JConfig
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.models.siglip import map_head as j_map_head
from tpudf.models.siglip import siglip_forward as j_siglip
from tpudf.ops import int8_block as J_int8
from tpudf.ops import layernorm as J_ln
from tpudf.ops import quant as J_quant
from tpudf_torch.convert import params_from_numpy, params_to_numpy
from tpudf_torch.models.siglip import CONFIGS, SigLIPConfig, siglip_forward
from tpudf_torch.ops import int8_block, layernorm, quant

W, HEADS, HD, INTER = 128, 2, 64, 256
ROUTES = ["FPP", "FPX", "PPP", "PPX", "PXP", "PXX", "XPP", "XPX", "XXP",
          "XXX", "LLL"]
TOWER = (128, 2, 2, 256, 32, 8)     # width, layers, heads, MLP, image, patch


@pytest.fixture(autouse=True, scope="module")
def persist_every_compile():
    """Keep even sub-second compiles of this module's JAX graphs in the
    persistent cache (tests/conftest.py keeps those of a second or more):
    each graph runs once, so tracing and compiling are its whole cost."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    yield
    jax.config.update(key, old)


def _compile(fn, *args):
    """jax.jit(fn) compiled for args without LLVM's optimisation passes,
    traced in a fresh thread: JAX records the Python stack of every
    operation it traces, and under pytest that stack is deep (the tower
    graph traced 16.8 s on the test's own stack, 12.0 s in a new thread)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        lowered = pool.submit(jax.jit(fn).lower, *args).result()
    return lowered.compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


def _np(x):
    return x.detach().float().numpy()


def _qw(rng, a, c, std=0.05):
    """{q, scale} of a seeded weight (the port's quantize_weight equals
    JAX's bit for bit: tests/test_torch_port_ops.py)."""
    wq = quant.quantize_weight(_t(rng.normal(0, std, (a, c)).astype(
        np.float32)))
    return {k: v.numpy() for k, v in wq.items()}


def _vec(rng, n, mean=0.0):
    return rng.normal(mean, 0.1, (n,)).astype(np.float32)


@jax.jit
def _jax_ln_codes(x, g, b, a):
    """JAX's f32 LN (eps 1e-6) of x's rows, its int8 codes with activation
    scale a, and whether each code's pre-rounding value lies within 1e-3
    of a rounding tie."""
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, -1, keepdims=True)
    var = jnp.maximum(jnp.mean(x32 * x32, -1, keepdims=True) - mu * mu, 0.0)
    y = (x32 - mu) * jax.lax.rsqrt(var + 1e-6) * g + b
    pre = y * (127.0 / a)
    tie = jnp.abs(jnp.abs(pre - jnp.floor(pre)) - 0.5) < 1e-3
    return J_int8._quant_rows(y, a), tie


def _flipped_rows(x, g, b, a):
    """Rows of x whose LN codes differ between the port and JAX; every
    differing code must sit within 1e-3 of a tie."""
    want, tie = map(np.asarray, _jax_ln_codes(x, g, b, np.float32(a)))
    got = quant.quant_rows(layernorm.ln_rows_f32(_t(x), _t(g), _t(b), 1e-6),
                           torch.tensor(a)).numpy()
    diff = got != want
    assert not (diff & ~tie).any()
    return diff.reshape(-1, diff.shape[-1]).any(-1)


# ---------------------------------------------------------------- K8

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_twin_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (4, 96, W)).astype(np.float32)
    g, b = _vec(rng, W, 1.0), _vec(rng, W)
    jx = jnp.asarray(x, dtype)
    x = np.asarray(jx, np.float32)            # the values both sides read
    want = np.asarray(_compile(lambda v: J_ln.layer_norm_quant(
        v, jnp.asarray(g), jnp.asarray(b), 3.0, interpret=True), jx)(jx))
    tx = _t(x).to(getattr(torch, dtype))
    got = layernorm.layer_norm_quant(tx, _t(g), _t(b), torch.tensor(3.0))
    assert got.dtype == torch.int8 and got.shape == tx.shape
    tie = np.asarray(_jax_ln_codes(x, g, b, np.float32(3.0))[1])
    diff = got.numpy() != want
    assert not (diff & ~tie).any()
    assert diff.mean() < 1e-3


# ---------------------------------------------------------------- K5

def test_k5_twin_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 64, W)).astype(np.float32)
    ln = {"scale": _vec(rng, W, 1.0), "bias": _vec(rng, W)}
    wq, bias = _qw(rng, W, 3 * W), _vec(rng, 3 * W)
    want = np.asarray(_compile(lambda v: J_int8.ln_qkv_int8(
        v, {k: jnp.asarray(a) for k, a in ln.items()},
        {k: jnp.asarray(a) for k, a in wq.items()}, jnp.asarray(bias), 3.0,
        interpret=True), x)(x))
    got = int8_block.ln_qkv_int8(_t(x), _tree_t(ln), _tree_t(wq), _t(bias),
                                 torch.tensor(3.0))
    flipped = _flipped_rows(x, ln["scale"], ln["bias"], 3.0).reshape(2, 64)
    assert flipped.mean() <= 0.01
    np.testing.assert_allclose(_np(got)[~flipped], want[~flipped],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- K6

@pytest.mark.parametrize("with_bias", [False, True])
def test_k6_twin_matches_pallas_interpret(with_bias):
    rng = np.random.default_rng(8)
    qkv = rng.normal(0, 1, (2, 64, 3 * W)).astype(np.float32)
    x = rng.normal(0, 1, (2, 64, W)).astype(np.float32)
    wq, bias = _qw(rng, W, W), _vec(rng, W)
    lb = (np.log(rng.integers(1, 5, (2, 64))).astype(np.float32)
          if with_bias else None)
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, {k: jnp.asarray(a) for k, a in wq.items()}, jnp.asarray(bias),
        2.0, HEADS, HD, interpret=True,
        logit_bias=None if lb is None else jnp.asarray(lb)), qkv, x)(qkv, x))
    got = int8_block.attn_out_int8(
        _t(qkv), _t(x), _tree_t(wq), _t(bias), torch.tensor(2.0), HEADS, HD,
        logit_bias=None if lb is None else _t(lb))
    np.testing.assert_allclose(_np(got), want, atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------- K7

def test_k7_twin_matches_pallas_interpret():
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 64, W)).astype(np.float32)
    bp = {"ln1": {"scale": _vec(rng, W, 1.0), "bias": _vec(rng, W)},
          "ln2": {"scale": _vec(rng, W, 1.0), "bias": _vec(rng, W)},
          "attn": {"qkv_w": _qw(rng, W, 3 * W), "qkv_b": _vec(rng, 3 * W),
                   "out_w": _qw(rng, W, W), "out_b": _vec(rng, W)},
          "mlp": {"fc1_w": _qw(rng, W, INTER), "fc1_b": _vec(rng, INTER),
                  "fc2_w": _qw(rng, INTER, W), "fc2_b": _vec(rng, W)},
          "act_scales": {k: np.float32(v) for k, v in
                         (("qkv", 3.0), ("out", 2.0), ("fc1", 3.0),
                          ("fc2", 2.0))}}
    jbp = jax.tree.map(jnp.asarray, bp)
    want = _compile(lambda v, p: J_int8.siglip_layer_int8(
        v, p, HEADS, HD, interpret=True), x, jbp)(x, jbp)
    assert want is not None
    tbp = _tree_t(bp)
    got = int8_block.siglip_layer_int8(_t(x), tbp, HEADS, HD)
    assert int8_block.layer_int8_eligible(_t(x), tbp, HEADS, HD)
    flipped = _flipped_rows(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                            3.0).reshape(2, 64)
    assert flipped.mean() <= 0.01
    np.testing.assert_allclose(_np(got)[~flipped], np.asarray(want)[~flipped],
                               atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------- tower

# Tolerances of the tower (bf16) against JAX's interpret run, all routes:
# the kernels JAX interprets quantise values the twins round to bf16 first
# (K1's and K6's f32 attention output; K7's f32 mid-layer residual), and
# the two frameworks' bf16 elementwise ops (the X routes' GELU and adds)
# round at other places; an int8 code that flips moves a token by about one
# quantisation step of the next projection. Measured on this test's inputs
# (|tokens|, |pooled| <= 3.3), images with JAX's merges: tokens up to 0.081
# (XPX without ToMe), 0 on PXP and XXP; pooled up to 0.047. The limits are
# 8 and 5 bf16 steps at magnitude 2-4.
_ROUTE_ATOL = {"tokens": 0.125, "pooled": 0.075}
_TOWER = {}


def _tower_setup():
    """Seeded numpy parameters of the test tower, calibrated and quantised
    (static W8A8) by the port, whose calibration and quantisation are held
    to JAX's by tests/test_torch_port_slice.py; both sides read this tree."""
    if "params" not in _TOWER:
        cfg = SigLIPConfig(*TOWER)
        floats = numpy_params(
            lambda: j_init_siglip(jax.random.key(0), JConfig(*TOWER)), 0)
        px = np.random.default_rng(1).uniform(-1, 1, (4, 32, 32, 3)).astype(
            np.float32)
        tp = params_from_numpy(floats, "cpu")
        q = quant.quantize_siglip_static(
            tp, quant.calibrate_siglip_act_scales(tp, cfg, _t(px)), cfg)
        _TOWER["params"] = params_to_numpy(q)
        _TOWER["px"] = px
    return _TOWER["params"], _TOWER["px"]


def _jax_towers(monkeypatch):
    """JAX's tokens, pooled and ToMe sizes under every route, without and
    with ToMe, from one graph: JAX reads the route while it traces, and one
    graph lowers the kernels the routes share once. `siglip_forward`'s
    pooled is `map_head` of its tokens (with log sizes as the logit bias
    under ToMe), so the towers run headless and JAX's `map_head` runs once
    per ToMe setting over every route's tokens, stacked on the batch."""
    if "routes" not in _TOWER:
        params, px = _tower_setup()
        jcfg = JConfig(*TOWER)
        headless = dataclasses.replace(jcfg, with_head=False)

        def every_route(p, x):
            out = {}
            for r in (0, 8):
                runs = []
                for route in ROUTES:
                    monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
                    runs.append(j_siglip(p, x, headless, tome_r=r,
                                         interpret=True))
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


@pytest.mark.parametrize("tome_r", [0, 8])
@pytest.mark.parametrize("route", ROUTES)
def test_tower_route_matches_jax(route, tome_r, monkeypatch):
    want = _jax_towers(monkeypatch)[f"{route}{tome_r}"]
    params, px = _tower_setup()
    monkeypatch.setenv("TPUDF_INT8_KERNELS", route)
    got = siglip_forward(params_from_numpy(params, "cpu"), _t(px),
                         SigLIPConfig(*TOWER), tome_r=tome_r)
    tokens, pooled, sizes = want
    # ToMe: an image whose merges differ from JAX's (a near-tie of the
    # matching scores, moved by the rounding above) has other tokens; it
    # is held by its pooled cosine, the others by the tolerances
    same = (np.ones(len(px), bool) if sizes is None else
            (got["sizes"].numpy() == np.asarray(sizes)).all(-1))
    assert same.sum() >= len(px) - 1, (route, same)
    for key, w in (("tokens", tokens), ("pooled", pooled)):
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got[key])[same],
                                   np.asarray(w, np.float32)[same],
                                   atol=_ROUTE_ATOL[key], rtol=0,
                                   err_msg=f"{route} {key}")
    a, b = _np(got["pooled"]), np.asarray(pooled, np.float32)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b,
                                                                        axis=-1)
    assert cos[same].min() >= 0.999 and cos.min() >= 0.98, (route, cos)


# ---------------------------------------------------------------- dynamic

_DYNAMIC_ATOL = 0.0625


_DYNAMIC = {}


def _dynamic_tree():
    """test-32's seeded float tree and JAX's quantize_siglip of it."""
    if not _DYNAMIC:
        jcfg = J_CONFIGS["test-32"]
        floats = numpy_params(lambda: j_init_siglip(jax.random.key(0), jcfg),
                              2)
        # eager, as the function runs when called: under jit XLA rewrites
        # its division by 127 and 6 of test-32's 128 qkv scales move by an
        # ulp (the port matches the eager function bit for bit)
        _DYNAMIC.update(jcfg=jcfg, floats=floats, tree=jax.tree.map(
            np.asarray, J_quant.quantize_siglip(floats)))
    return _DYNAMIC["jcfg"], _DYNAMIC["floats"], _DYNAMIC["tree"]


def test_dynamic_int8_block_matches_jax():
    jcfg, _, tree = _dynamic_tree()
    px = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = _compile(lambda p, x: j_siglip(p, x, jcfg, interpret=True)[
        "pooled"], tree, px)(tree, px)
    got = siglip_forward(params_from_numpy(tree, "cpu"), _t(px),
                         CONFIGS["test-32"])["pooled"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=_DYNAMIC_ATOL, rtol=0)


def test_dynamic_int8_tree_crosses_and_quantises_as_jax():
    _, floats, tree = _dynamic_tree()
    params = params_from_numpy(tree, "cpu")
    qkv = params["blocks"]["attn"]["qkv_w"]
    assert qkv["q"].dtype == torch.int8 and "qT" in qkv
    back = params_to_numpy(params)
    flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)
    mine = params_to_numpy(quant.quantize_siglip(
        params_from_numpy(floats, "cpu")))
    for path, leaf in flat_in:
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_flatten_with_path(mine)[0])[path], leaf)
