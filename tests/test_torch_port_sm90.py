"""K9 and K10 on wgmma and TMA (tpudf_torch/csrc/attention_sm90.cu): the
kernels' domain and a PyTorch model of their tiling, against the JAX
package on the CPU.

  (a) the domain  `sm90_fwd_fits` (K9) accepts exactly what the wrapper's
      `check_attention_shape` accepts, and `sm90_bwd_fits` (K10) every
      shape that JAX's Pallas backward admits (`attention_qkv_bwd_fits`,
      head_dim in BWD_HEAD_DIMS), over a grid of (B, S, heads, head_dim)
      with ragged S, S = 32, 1000, 1024, past 1024 (K9 takes S up to
      MAX_SEQ) and K10's S up to JAX's fit;
      shapes outside it are refused before any launch
  (b) the tiling  `k9_tile_model` and `k10_tile_model` compute what the
      kernels compute in their order: 64-key tiles; in K9's pass 1 the
      row max and sum online, each of a row's four threads summing its 16
      keys of a tile (keys 8 j + 2 t + e, j then e) and rescaling at a new
      max, the four partial sums added pairwise at the end; in K10's dq
      pass the max first, then the sum and D in the same per-thread order
      against the final max; p rounded to bf16 only for p . v (dV), dS
      only for dQ and dK. Held against `_attention_qkv_pallas` and
      `_attention_qkv_bwd_pallas` in interpret mode at S 256, 576 and
      1000 (ragged), head_dim 64 and 128, in bf16 within atol 1e-2 + rtol
      2^-7 (f32 sums in another order before one bf16 rounding), K9 with
      the per-key bias against `_reference_qkv` (JAX's route for a bias)
      within the same, and in f32 against `_reference_qkv` and
      `jax.vjp(_reference_qkv)` within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.ops import attention as J_attn
from tpudf_torch.ops import attention

BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
TILE = attention.SM90_TILE_ROWS


# ------------------------------------------------------------ (a) domain

_GRID_S = [1, 8, 32, 60, 64, 136, 200, 256, 576, 1000, 1024, 1025, 1560,
           1568, 2048, 2056]


@pytest.mark.parametrize("head_dim", [32, 64, 72, 128])
def test_k9_kernel_domain_is_the_wrappers(head_dim):
    """K9's kernel takes exactly the shapes `check_attention_shape` lets
    through to it, at every S of the grid (ragged ones included)."""
    for b in (1, 8):
        for heads in (1, 2, 12, 16):
            for s in _GRID_S:
                qkv = torch.empty((b, s, 3 * heads * head_dim),
                                  dtype=torch.bfloat16)
                try:
                    attention.check_attention_shape("K9", qkv, heads,
                                                    head_dim)
                    old = True
                except ValueError:
                    old = False
                new = attention.sm90_fwd_fits(s, heads * head_dim, head_dim)
                assert new == old, (b, s, heads, head_dim)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_k10_kernel_domain_covers_jax_fit(head_dim):
    """Every (S, W) at which JAX runs its Pallas backward (S a multiple of
    8 up to its 12 MiB fit) is one K10's kernels take, its dkv block's
    shared memory within a block's; the wrapper's check passes there."""
    taken = 0
    for w in (128, 256, 768, 1024, 2048):
        for s in range(8, 2100, 8):
            if not attention.attention_qkv_bwd_fits(s, w, head_dim):
                continue
            assert head_dim in attention.BWD_HEAD_DIMS
            assert attention.sm90_bwd_fits(s, w, head_dim), (s, w)
            assert (attention.sm90_dkv_smem(s, head_dim)
                    <= attention.SM90_BLOCK_SMEM)
            heads = w // head_dim
            attention.check_attention_bwd_shape(
                "K10", torch.empty((1, s, 3 * w), dtype=torch.bfloat16),
                torch.empty((1, s, w), dtype=torch.bfloat16), heads,
                head_dim)
            taken += 1
    assert taken > 100


def test_kernels_refuse_shapes_outside_their_domain():
    """A shape past the kernels' domain raises before any launch."""
    bf = torch.bfloat16
    with pytest.raises(ValueError):
        attention.check_attention_bwd_shape(
            "K10", torch.empty((1, 2056, 384), dtype=bf),
            torch.empty((1, 2056, 128), dtype=bf), 2, 64)
    with pytest.raises(ValueError):
        attention.check_attention_bwd_shape(
            "K10", torch.empty((1, 64, 3 * 144), dtype=bf),
            torch.empty((1, 64, 144), dtype=bf), 2, 72)
    # K9 takes S past 1024 up to MAX_SEQ (its K/V tiles stream) and no
    # further
    assert attention.sm90_fwd_fits(1025, 128, 64)
    assert attention.sm90_fwd_fits(attention.MAX_SEQ, 128, 64)
    assert not attention.sm90_fwd_fits(attention.MAX_SEQ + 1, 128, 64)
    assert not attention.sm90_fwd_fits(256, 144, 72)


# ------------------------------------------------------------ (b) tiling

def _heads_first(t, heads, head_dim):
    b, s, _ = t.shape
    return t.reshape(b, s, heads, head_dim).transpose(1, 2).float()


def _thread_order(tile):
    """(..., 64) keys of a tile → (..., 4, 16): thread t's 16 keys 8 j + 2 t
    + e in the order it adds them (j, then e)."""
    x = tile.reshape(*tile.shape[:-1], 8, 4, 2)
    x = x.transpose(-3, -2)
    return x.reshape(*tile.shape[:-1], 4, 16)


def _quad_sum(part):
    """The four threads' partial sums of a row, as the shuffles add them."""
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def _padded_scores(q, k, scale, bias=None):
    """(q . k) * scale (+ bias), keys padded with -inf to whole tiles."""
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :].float()
    n = s.shape[-1]
    pad = -(-n // TILE) * TILE - n
    return torch.nn.functional.pad(s, (0, pad), value=float("-inf"))


def k9_tile_model(qkv, heads, head_dim, scale, bias=None, round_p=True):
    """K9 in the kernel's order: pass 1 online over 64-key tiles, pass 2
    p = exp(s - m) / l, rounded to bf16 (round_p) for p . v."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (_heads_first(qkv[..., i * w:(i + 1) * w], heads, head_dim)
               for i in range(3))
    sc = _padded_scores(q, k, scale, bias)
    m = torch.full(sc.shape[:-1], float("-inf"))
    part = torch.zeros(*sc.shape[:-1], 4)
    for t in range(sc.shape[-1] // TILE):
        tile = _thread_order(sc[..., t * TILE:(t + 1) * TILE])
        tm = torch.maximum(m, tile.amax(dim=(-1, -2)))
        part = torch.where((tm != m)[..., None],
                           part * torch.exp(m - tm)[..., None], part)
        m = tm
        for i in range(16):
            part = part + torch.exp(tile[..., i] - m[..., None])
    p = torch.exp(sc[..., :s] - m[..., None]) / _quad_sum(part)[..., None]
    if round_p:
        p = p.bfloat16().float()
    o = p @ v
    return o.transpose(1, 2).reshape(b, s, w).to(qkv.dtype)


def k10_tile_model(qkv, g, heads, head_dim, scale, round_ds=True):
    """K10 in the kernels' order: the dq pass's row max, then the row sum
    and D = rowsum(dP * P) per thread against the final max, dS = P (dP -
    D) scale; dQ = bf16(dS) K; the dkv pass's P from the saved max and
    sum, dV = bf16(P)^T g, dK = bf16(dS)^T Q (round_ds: the bf16
    roundings)."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (_heads_first(qkv[..., i * w:(i + 1) * w], heads, head_dim)
               for i in range(3))
    gh = _heads_first(g, heads, head_dim)
    sc = _padded_scores(q, k, scale)
    n_t = sc.shape[-1] // TILE
    m = sc.amax(dim=-1)
    part = torch.zeros(*sc.shape[:-1], 4)
    for t in range(n_t):
        tile = _thread_order(sc[..., t * TILE:(t + 1) * TILE])
        for i in range(16):
            part = part + torch.exp(tile[..., i] - m[..., None])
    p = torch.exp(sc - m[..., None]) / _quad_sum(part)[..., None]
    dp = torch.nn.functional.pad(gh @ v.transpose(-1, -2),
                                 (0, sc.shape[-1] - s))
    prod = dp * p
    part = torch.zeros_like(part)
    for t in range(n_t):
        tile = _thread_order(prod[..., t * TILE:(t + 1) * TILE])
        for i in range(16):
            part = part + tile[..., i]
    d = _quad_sum(part)
    p, dp = p[..., :s], dp[..., :s]
    ds = (p * (dp - d[..., None])) * scale
    rnd = (lambda x: x.bfloat16().float()) if round_ds else (lambda x: x)
    dq = rnd(ds) @ k
    dk = rnd(ds).transpose(-1, -2) @ q
    dv = rnd(p).transpose(-1, -2) @ gh
    return torch.cat([t.transpose(1, 2).reshape(b, s, w)
                      for t in (dq, dk, dv)], dim=-1).to(qkv.dtype)


def _qkv(s, head_dim, seed, std=1.5):
    heads = 128 // head_dim
    rng = np.random.default_rng(seed)
    qkv = (rng.standard_normal((1, s, 3 * 128)) * std).astype(np.float32)
    g = rng.standard_normal((1, s, 128)).astype(np.float32)
    bias = np.log(rng.integers(1, 6, (1, s))).astype(np.float32)
    return heads, qkv, g, bias


def _bf16(a):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s", [256, 576, 1000])
def test_k9_tiling_matches_pallas_interpret(s, head_dim):
    heads, qkv, _, _ = _qkv(s, head_dim, s + head_dim)
    jq, tq = _bf16(qkv)
    scale = head_dim ** -0.5
    want = J_attn._attention_qkv_pallas(jq, heads, head_dim, scale,
                                        interpret=True)
    _close(k9_tile_model(tq, heads, head_dim, scale), want, **BF16_STEP)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s", [256, 1000])
def test_k9_tiling_with_bias_matches_jax_reference(s, head_dim):
    heads, qkv, _, bias = _qkv(s, head_dim, 3 * s + head_dim)
    jq, tq = _bf16(qkv)
    scale = head_dim ** -0.5
    want = J_attn._reference_qkv(jq, heads, head_dim, scale,
                                 jnp.asarray(bias))
    got = k9_tile_model(tq, heads, head_dim, scale, torch.from_numpy(bias))
    _close(got, want, **BF16_STEP)


@pytest.mark.parametrize("with_bias", [False, True])
def test_k9_tiling_matches_jax_reference_f32(with_bias):
    heads, qkv, _, bias = _qkv(1000, 64, 11, std=1.0)
    scale = 64 ** -0.5
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    want = J_attn._reference_qkv(jnp.asarray(qkv), heads, 64, scale, jb)
    got = k9_tile_model(torch.from_numpy(qkv), heads, 64, scale, tb,
                        round_p=False)
    _close(got, want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("s", [256, 576, 1000])
def test_k10_tiling_matches_pallas_interpret(s, head_dim):
    heads, qkv, g, _ = _qkv(s, head_dim, 5 * s + head_dim)
    jq, tq = _bf16(qkv)
    jg, tg = _bf16(g)
    scale = head_dim ** -0.5
    want = J_attn._attention_qkv_bwd_pallas(jq, jg, heads, head_dim, scale,
                                            interpret=True)
    got = k10_tile_model(tq, tg, heads, head_dim, scale)
    _close(got, want, **BF16_STEP)


def test_k10_tiling_matches_jax_vjp_f32():
    heads, qkv, g, _ = _qkv(1000, 128, 13, std=1.0)
    scale = 72 ** -0.5                 # so400m's scale at padded heads
    _, vjp = jax.vjp(lambda t: J_attn._reference_qkv(t, heads, 128, scale),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    got = k10_tile_model(torch.from_numpy(qkv), torch.from_numpy(g), heads,
                         128, scale, round_ds=False)
    _close(got, want, atol=2e-3, rtol=2e-3)
