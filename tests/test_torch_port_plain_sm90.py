"""Kernels 11 and 12 redesigned (tpudf_torch/csrc/attention_plain_sm90.cu
in bf16, attention_plain.cu in f32): their domain and a PyTorch model of
each kernel's order of operations, against the JAX package on the CPU.

  (a) the domain  `check_plain_attention` (on meta tensors) admits exactly
      what it admitted before the redesign: bf16 at head_dim 64, 72 and
      128, f32 at any head_dim <= 128, one dtype, any Sq and Skv >= 1, in
      both layouts; `plain_fits` is that rule, and every shape it admits
      has a block whose shared memory (`plain_sm90_smem`,
      `plain_f32_smem`, which the card's phase 1 holds to the kernels'
      own) fits a block
  (b) the bf16 tiling  `bf16_tile_model` computes what the wgmma kernel
      computes in its order: 64-key tiles; pass 1 online, each of a row's
      four threads summing its 16 keys of a tile (8 j + 2 t + e, j then e)
      and rescaling at the tile's new max, the four partial sums added
      pairwise at the end; pass 2 p = e / l in f32 rounded to bf16 for p .
      v, o summed in f32 and rounded once; heads of 72 on the 80-wide
      tile (zero columns); the softmax's instructions as the kernel's
      (scores that carry log2 e, 2^(s' - m'), p = e r with r = 1 / l) or
      K9's (exp, p = e / l). Held against `_attention_pallas` /
      `_attention_pallas_bshd` in interpret mode at Sq != Skv, ragged Skv
      (100, 577, 1000), Sq = 1 and heads of 72, bf16 within atol 1e-2 +
      rtol 2^-7 (f32 sums in another order before one bf16 rounding); the
      two sequences at most 1e-2 of outputs a bf16 step apart (the card's
      limit; the kernel is built with the first only)
  (c) the f32 order  `f32_order_model`: each thread's running max and sum
      of a row over its keys tx + 16 j of each tile (16 threads a row),
      merged once (within the warp's eight lanes by xor 1, 2, 4, then the
      two key halves), p = e r, o = p . v in f32; against JAX's
      `attention_reference` at f32 within atol 5e-4 + rtol 1e-3 (JAX's own
      bound for the kernel)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_sm90 import _quad_sum, _thread_order
from tpudf.ops import attention as J_attn
from tpudf_torch.ops import attention

BF16_STEP = dict(atol=1e-2, rtol=2 ** -7)
F32_TOL = dict(atol=5e-4, rtol=1e-3)
TILE = 64                        # keys a tile, both kernels
LOG2E = 1.4426950408889634


# ------------------------------------------------------------ (a) domain

def _admits(dtype, d, bshd):
    """check_plain_attention on meta tensors of (1, 2, 5, 7, d)."""
    shapes = ([(1, 5, 2, d), (1, 7, 2, d)] if bshd
              else [(1, 2, 5, d), (1, 2, 7, d)])
    q, k = (torch.empty(s, dtype=dtype, device="meta") for s in shapes)
    try:
        attention.check_plain_attention("kernel", q, k, k.clone(), bshd)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_plain_domain_is_unchanged(dtype, bshd):
    dt = getattr(torch, dtype)
    want = {"bfloat16": {64, 72, 128}, "float32": set(range(0, 129)),
            "float16": set()}[dtype]
    got = {d for d in range(0, 200) if _admits(dt, d, bshd)}
    assert got == want
    assert all(attention.plain_fits(dt, d) == (d in want)
               for d in range(0, 200))


def test_plain_domain_refuses_mismatches():
    """Mixed dtypes, k and v of two shapes, another head count or
    head_dim, Skv = 0: refused before any launch."""
    def e(*s, dt=torch.bfloat16):
        return torch.empty(s, dtype=dt, device="meta")

    bad = [(e(1, 2, 5, 64), e(1, 2, 7, 64, dt=torch.float32),
            e(1, 2, 7, 64)),
           (e(1, 2, 5, 64), e(1, 2, 7, 64), e(1, 2, 8, 64)),
           (e(1, 2, 5, 64), e(1, 3, 7, 64), e(1, 3, 7, 64)),
           (e(1, 2, 5, 64), e(1, 2, 7, 72), e(1, 2, 7, 72)),
           (e(1, 2, 5, 64), e(1, 2, 0, 64), e(1, 2, 0, 64))]
    for q, k, v in bad:
        with pytest.raises(ValueError):
            attention.check_plain_attention("kernel 11", q, k, v)


def test_plain_blocks_fit_shared_memory():
    """Every admitted head_dim has a block: the bf16 kernel's 64-, 80- (heads
    of 72) or 128-wide tile and the f32 kernel's block of PLAIN_F32_ROWS
    rows, within a block's shared memory."""
    smem = {d: attention.plain_sm90_smem(d) for d in (64, 72, 128)}
    assert max(smem.values()) <= attention.SM90_BLOCK_SMEM
    assert smem[72] < smem[128]
    for d in range(0, attention.PLAIN_F32_MAX_HEAD_DIM + 1):
        assert attention.plain_f32_smem(d) <= attention.SM90_BLOCK_SMEM
    # three blocks of 48 rows an SM at head_dim <= 64 (228 KB a card's SM)
    assert attention.PLAIN_F32_ROWS == 48
    assert 3 * (attention.plain_f32_smem(64) + 1024) <= 233472


# ------------------------------------------------------------ (b) bf16

def _mul(scale, exact=False):
    """The kernels' f32 score multiplier: the scale, or (the port's
    sequence) the f32 scale times f32 log2 e, rounded to f32."""
    mul = torch.tensor(scale, dtype=torch.float32)
    return mul if exact else mul * torch.tensor(LOG2E, dtype=torch.float32)


def _padded(s, n):
    """Scores (..., Skv) padded with -inf to whole 64-key tiles."""
    pad = -(-n // TILE) * TILE - n
    return torch.nn.functional.pad(s, (0, pad), value=float("-inf"))


def bf16_tile_model(q, k, v, scale, exact=False):
    """The wgmma kernel's order on (B, H, S, D) q, k, v in bf16 (held in
    f32): the 80-wide tile at heads of 72 (zero columns), scores in f32,
    pass 1 online per thread, pass 2 p rounded to bf16 for p . v."""
    d = q.shape[-1]
    width = {64: 64, 72: 80}.get(d, 128)
    q, k, v = (torch.nn.functional.pad(t.float(), (0, width - d))
               for t in (q, k, v))
    skv = k.shape[-2]
    mul = _mul(scale, exact)
    ex = torch.exp if exact else torch.exp2
    sc = _padded((q @ k.transpose(-1, -2)) * mul, skv)
    m = torch.full(sc.shape[:-1], float("-inf"))
    part = torch.zeros(*sc.shape[:-1], 4)
    for t in range(sc.shape[-1] // TILE):
        tile = _thread_order(sc[..., t * TILE:(t + 1) * TILE])
        tm = torch.maximum(m, tile.amax(dim=(-1, -2)))
        part = torch.where((tm != m)[..., None],
                           part * ex(m - tm)[..., None], part)
        m = tm
        for i in range(16):
            part = part + ex(tile[..., i] - m[..., None])
    l = _quad_sum(part)[..., None]
    e = ex(sc[..., :skv] - m[..., None])
    p = e / l if exact else e * (1.0 / l)
    o = p.bfloat16().float() @ v
    return o[..., :d].bfloat16()


def _qkv(shape, seed, std=1.5):
    b, h, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, n, d)) * std).astype(np.float32)
            for n in (sq, skv, skv)]


def _bf16(arrays):
    """bf16 copies for JAX and for torch (the same values)."""
    t = [torch.from_numpy(a).bfloat16() for a in arrays]
    return [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in t], t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# (B, H, Sq, Skv, D, layout): Sq != Skv with ragged keys, Sq = 1 over a
# ragged tile of one key, 577 over 1000 keys, heads of 72 in both layouts
_BF16_CASES = [(1, 2, 100, 100, 64, "bhsd"), (1, 2, 77, 577, 64, "bshd"),
               (1, 2, 577, 1000, 64, "bhsd"), (1, 2, 1, 577, 64, "bshd"),
               (1, 2, 130, 100, 72, "bshd"), (1, 2, 3, 1000, 72, "bhsd"),
               (1, 2, 64, 200, 128, "bshd")]


@pytest.mark.parametrize("case", _BF16_CASES, ids=str)
def test_plain_bf16_tiling_matches_pallas_interpret(case):
    *shape, layout = case
    d = shape[-1]
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(shape, sum(shape)))
    if layout == "bshd":
        tr = lambda x: x.transpose(0, 2, 1, 3)
        want = J_attn._attention_pallas_bshd(tr(jq), tr(jk), tr(jv),
                                             d ** -0.5, interpret=True)
        want = np.asarray(want, np.float32).transpose(0, 2, 1, 3)
    else:
        want = J_attn._attention_pallas(jq, jk, jv, d ** -0.5,
                                        interpret=True)
    _close(bf16_tile_model(tq, tk, tv, d ** -0.5), want, **BF16_STEP)


def test_plain_bf16_softmax_sequences_agree():
    """The kernel's sequence and K9's move few outputs a bf16 step: at most
    1e-2 of them (the card's check), both within the tolerance of the
    twin."""
    shape = (1, 2, 200, 577, 72)
    _, (tq, tk, tv) = _bf16(_qkv(shape, 7))
    scale = 72 ** -0.5
    ours = bf16_tile_model(tq, tk, tv, scale).float()
    k9 = bf16_tile_model(tq, tk, tv, scale, exact=True).float()
    twin = attention.attention_reference(tq, tk, tv, scale).float()
    step = torch.exp2(torch.floor(torch.log2(
        torch.maximum(ours.abs(), k9.abs()).clamp_min(1e-30))) - 7)
    assert float(((ours - k9).abs() > step).float().mean()) <= 1e-2
    for got in (ours, k9):
        torch.testing.assert_close(got, twin, **BF16_STEP)


# ------------------------------------------------------------ (c) f32

def f32_order_model(q, k, v, scale):
    """The SIMT kernel's order on (B, H, S, D) f32 q, k, v: thread tx of a
    row's 16 holds keys tx + 16 j of each tile, its own running (max, sum)
    rescaled at a new max, merged within its warp's eight lanes (xor 1, 2,
    4) and then across the two key halves; p = 2^(s' - m') r."""
    skv = k.shape[-2]
    sc = _padded((q @ k.transpose(-1, -2)) * _mul(scale), skv)
    rows = sc.shape[:-1]
    ninf = torch.tensor(float("-inf"))
    m = torch.full((*rows, 16), float("-inf"))
    l = torch.zeros((*rows, 16))
    for t in range(sc.shape[-1] // TILE):
        tile = sc[..., t * TILE:(t + 1) * TILE].reshape(*rows, 4, 16)
        tm = torch.maximum(m, tile.amax(dim=-2))
        live = tm != ninf
        grow = live & (tm != m)
        l = torch.where(grow, l * torch.exp2(m - tm), l)
        m = torch.where(live, tm, m)
        for j in range(4):
            l = torch.where(live, l + torch.exp2(tile[..., j, :] - tm), l)

    def merge(m_, l_, mo, lo):
        mn = torch.maximum(m_, mo)
        ok = mn != ninf
        mn_ = torch.where(ok, mn, torch.zeros_like(mn))
        new = l_ * torch.exp2(m_ - mn_) + lo * torch.exp2(mo - mn_)
        return torch.where(ok, mn, m_), torch.where(ok, new, l_)

    lanes = torch.arange(16)
    for off in (1, 2, 4):
        m, l = merge(m, l, m[..., lanes ^ off], l[..., lanes ^ off])
    mrow, lrow = merge(m[..., 0], l[..., 0], m[..., 8], l[..., 8])
    p = torch.exp2(sc[..., :skv] - mrow[..., None]) * (1.0 / lrow[..., None])
    return p @ v


@pytest.mark.parametrize("shape", [(1, 2, 100, 577, 64), (2, 2, 1, 1000, 37),
                                   (1, 2, 130, 64, 128)], ids=str)
def test_plain_f32_order_matches_jax_reference(shape):
    q, k, v = _qkv(shape, 3 + sum(shape))
    d = shape[-1]
    want = J_attn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), d ** -0.5)
    got = f32_order_model(*(torch.from_numpy(a) for a in (q, k, v)),
                          d ** -0.5)
    _close(got, want, **F32_TOL)
