"""K5 (LN + quant + int8 QKV) on the int8 wgmma GEMM with its LN panel, and
9b (dynamic-int8 attention) as a pre-pass plus an int8 wgmma main pass
(tpudf_torch/csrc/int8_gemm_sm90.cu, csrc/attention_i8.cu): numpy models of
their schedules, layouts and order against the port's twins and JAX's
Pallas kernels, on the CPU.

  (a) K5's walk  `int8_block.k5_units` (row tiles x runs of their column
      tiles over 132 SMs, `k5_splits` runs a row tile) at every K5 shape
      of the paths (the three backbones at B = 8 / 64 / 128 / 256, without
      ToMe and at every token count of the deployed main and patch
      schedules, and W 832 and 1280): every output tile once, each from a
      panel built of its own rows, the LN of a row computed `k5_splits`
      times (6 / 3 / 2 at B = 8 for base-256 / large-384 / so400m-512)
  (b) K5's panel  a numpy model of the kernel's LN (K8's statistics in the
      kernel's order) written into the panel as the kernel writes it (a
      row's 16-byte chunk c of slice k at chunk c ^ (row % 8)), read back
      through wgmma's K-major 128-byte-swizzle layout (the address bits
      4-6 XOR bits 7-9, k32 steps 32 bytes on): the codes exactly, zeros
      past M and past K; those codes' int32 product with the twin's
      epilogue equals `ln_qkv_reference`'s output bit for bit in every row
      whose codes equal the twin's (a code at a rounding tie of the f32
      LN may differ by one: at most 1e-4 of them)
  (c) 9b  a numpy model of the pre-pass (the amax table, q8 and k8 rows,
      v8 transposed in `vt_pos` order, zeros past S) equal to
      `attention_i8_codes_reference` and to the twin's codes; the A
      fragment of wgmma's k32 step built from the score accumulators
      holds at byte 4t + i the key `vt_pos` puts there; the main pass's
      order (items of 128 rows, 64-key tiles, the first sweep's online
      max and per-thread sums reduced over the quad, the second sweep's
      p8 = rint(2^(s - m) r * (127 / ap)) against v8t) at S 576 / 1000 /
      1024, heads of 64 and of 128 (72 live) against JAX's
      `_attention_qkv_pallas(interpret=True, int8_attn=True)` by 9b's CPU
      rule (one bf16 step, but in rows with a probability code within
      1e-3 of a tie, at most 1 % of the rows), while v8t in natural key
      order gives another result
  (d) the entry points  every C signature of `_build.SIGNATURES` is
      defined in one csrc file, and K5's split and stage constants equal
      the source's
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_large import _bf16_step, _p8_ties, _qkv
from tests.test_torch_port_variants import _compile
from tpudf.ops.attention import _attention_qkv_pallas
from tpudf_torch.ops import _build, attention, int8_block, layernorm, quant
from tpudf_torch.ops.tome import (DEPLOYED_PATCH_TOME_R, DEPLOYED_TOME_R,
                                  deployed_floor, deployed_patch_floor,
                                  merge_schedule)

F32 = np.float32
# (width, layers, tokens, QKV columns as the kernels see them)
BACKBONES = {"base-256": (768, 12, 256, 2304),
             "large-384": (1024, 24, 576, 3072),
             "so400m-512": (1152, 27, 1024, 6144)}


# ------------------------------------------------------------ (a) the walk

def _token_counts(n, layers):
    """Every S a layer sees: no ToMe, and the main and patch schedules."""
    out = {n}
    for r, floor in ((DEPLOYED_TOME_R, deployed_floor(n)),
                     (DEPLOYED_PATCH_TOME_R, deployed_patch_floor(n))):
        s = n
        for ri in merge_schedule(n, layers, r, floor):
            s -= ri
            out.add(s)
    return sorted(out)


def _k5_shapes():
    shapes = set()
    for w, layers, n, cols in BACKBONES.values():
        for b in (8, 64, 128, 256):
            for s in _token_counts(n, layers):
                shapes.add((b * s, w, cols))
    shapes |= {(2049, 832, 2304), (8 * 257, 1152, 6144), (1000, 1280, 3840)}
    return sorted(shapes)


def test_k5_walk_covers_every_tile_once_from_its_own_panel():
    shapes = _k5_shapes()
    assert len(shapes) > 60
    for m, w, n in shapes:
        units = int8_block.k5_units(m, n)
        rows, tiles = -(-m // 128), n // 128
        assert 1 <= len(units) <= int8_block.H100_SMS
        seen = np.zeros((rows, tiles), np.int64)
        runs = np.zeros(rows, np.int64)
        for block in units:
            panel = None
            for rt, t0, t1 in block:
                panel = rt                    # rebuilt at every unit
                runs[rt] += 1
                assert t0 < t1
                for tn in range(t0, t1):
                    assert panel == rt
                    seen[rt, tn] += 1
        assert (seen == 1).all(), (m, w, n)
        # the LN of each row: once a run
        assert (runs == int8_block.k5_splits(m, n)).all()


@pytest.mark.parametrize("name,b,want", [
    ("base-256", 8, 6), ("large-384", 8, 3), ("so400m-512", 8, 2),
    ("base-256", 256, 1), ("large-384", 128, 1), ("so400m-512", 64, 1)])
def test_k5_ln_recomputation_per_row(name, b, want):
    """The runs a row tile is cut in, i.e. how often a row's LN is
    computed: at B = 8 at most 9 / 4 / 3 (the mma.sync K5 computed it
    N / 128 = 18 / 24 / 48 times), 1 where the row tiles fill the card."""
    w, _, n, cols = BACKBONES[name]
    s = int8_block.k5_splits(b * n, cols)
    assert s == want
    units = -(-b * n // 128) * s
    print(f"K5 {name} B={b}: ({b * n}, {w} -> {cols}), {s} runs a row "
          f"tile, {units} units, {-(-units // 132)} waves")


# ------------------------------------------------------------ (b) the panel

def _ln_codes_model(x, g, b, a, eps=1e-6):
    """The kernel's LN + quant of bf16 rows x (M, K) in numpy f32, op by op
    in its order: lane l sums its chunks l, l + 32, .. (8 values each) of
    x and x^2 (x^2 fused into the add), the warp reduces by xor 16 .. 1,
    mu = s / K, var = max(E[x^2] - mu^2 (fused), 0), rstd = 1 / sqrt(var +
    eps), y = ((x - mu) rstd) g + b, codes clip(rint(y (127 / a)))."""
    m, k = x.shape
    xc = x.reshape(m, k // 8, 8).astype(F32)
    s = np.zeros((m, 32), F32)
    ss = np.zeros((m, 32), F32)
    for c in range(5):
        for lane in range(32):
            ch = lane + 32 * c
            if ch >= k // 8:
                continue
            for j in range(8):
                v = xc[:, ch, j]
                s[:, lane] = s[:, lane] + v
                ss[:, lane] = (ss[:, lane].astype(np.float64)
                               + v.astype(np.float64) ** 2).astype(F32)
    for o in (16, 8, 4, 2, 1):
        idx = np.arange(32) ^ o
        s = (s + s[:, idx]).astype(F32)
        ss = (ss + ss[:, idx]).astype(F32)
    mu = (s[:, 0] / F32(k)).astype(F32)
    m2 = (ss[:, 0] / F32(k)).astype(F32)
    var = np.maximum((m2.astype(np.float64) - mu.astype(np.float64) ** 2)
                     .astype(F32), F32(0))
    rstd = (F32(1) / np.sqrt((var + F32(eps)).astype(F32))).astype(F32)
    y = ((((x.astype(F32) - mu[:, None]).astype(F32) * rstd[:, None])
          .astype(F32) * g[None]).astype(F32) + b[None]).astype(F32)
    inv = F32(F32(127) / F32(a))
    return np.clip(np.rint((y * inv).astype(F32)), -127, 127).astype(np.int8)


def _write_panel(codes, m0, k):
    """The kernel's panel of the row tile at m0 (ln_panel): slice k at k
    16 KB, a row's 16-byte chunk c at chunk c ^ (row % 8)."""
    nk = -(-k // 128)
    panel = np.full(nk * 16384, 0x55, np.uint8)   # stale bytes
    for pr in range(128):
        row = m0 + pr
        for chunk in range(nk * 16):
            col = chunk * 8
            q = (codes[row, col:col + 8] if row < codes.shape[0]
                 and chunk < k // 8 else np.zeros(8, np.int8))
            at = ((col // 128) * 16384 + pr * 128
                  + ((((col % 128) >> 4) ^ (pr & 7)) << 4) + (col & 15))
            panel[at:at + 8] = q.view(np.uint8)
    return panel


def _read_k_major(panel, nk):
    """The (128, nk 128) A tile wgmma reads from the panel: per slice and
    k32 step, a K-major 128-byte-swizzle descriptor (8-row atoms 1024
    bytes apart) whose start moves 32 bytes a step; the swizzle XORs
    address bits 4-6 with bits 7-9."""
    a = np.zeros((128, nk * 128), np.int8)
    r = np.arange(128)[:, None]
    kk = np.arange(32)[None, :]
    for sl in range(nk):
        for ks in range(4):
            addr = (sl * 16384 + 32 * ks + (r // 8) * 1024 + (r % 8) * 128
                    + kk)
            addr = addr ^ (((addr >> 7) & 7) << 4)
            a[:, sl * 128 + 32 * ks:sl * 128 + 32 * ks + 32] = (
                panel[addr].view(np.int8))
    return a


@pytest.mark.parametrize("m,k,n", [(300, 832, 256), (200, 1152, 384),
                                   (130, 1280, 128)])
def test_k5_panel_model_matches_twin(m, k, n):
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy((rng.normal(0.5, 3.0, (m, k))).astype(F32)).to(
        torch.bfloat16)
    g = (1 + rng.normal(0, 0.1, k)).astype(F32)
    b = rng.normal(0, 0.1, k).astype(F32)
    a = F32(4.0)
    codes = _ln_codes_model(x.float().numpy(), g, b, a)
    nk = -(-k // 128)
    got = np.zeros((-(-m // 128) * 128, nk * 128), np.int8)
    for m0 in range(0, m, 128):
        got[m0:m0 + 128] = _read_k_major(_write_panel(codes, m0, k), nk)
    want = np.zeros_like(got)
    want[:m, :k] = codes
    np.testing.assert_array_equal(got, want)

    # the codes against the twin's (K8's reference form): f32 LN ties only
    twin = layernorm.layer_norm_quant_reference(
        x, torch.from_numpy(g), torch.from_numpy(b), torch.tensor(a)).numpy()
    diff = np.abs(codes.astype(np.int64) - twin)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    # the product and the twin's epilogue against ln_qkv_reference
    wq = quant.quantize_weight(torch.from_numpy(
        rng.normal(0, k ** -0.5, (k, n)).astype(F32)))
    bias = torch.from_numpy(rng.normal(0, 0.1, n).astype(F32))
    acc = quant.int8_mm(torch.from_numpy(got[:m, :k].copy()), wq["q"])
    out = (acc.float() * ((torch.tensor(a) / 127.0) * wq["scale"].float())
           + bias).to(torch.bfloat16)
    ref = int8_block.ln_qkv_reference(
        x, {"scale": torch.from_numpy(g), "bias": torch.from_numpy(b)}, wq,
        bias, torch.tensor(a))
    same_rows = (diff == 0).all(-1)
    assert same_rows.mean() >= 0.95
    assert torch.equal(out[torch.from_numpy(same_rows)],
                       ref[torch.from_numpy(same_rows)])


# ------------------------------------------------------------------ (c) 9b

def _vt_order(sp):
    return np.array([attention.vt_pos(x) for x in range(sp)])


def test_vt_pos_is_the_a_fragments_order():
    """Lane t's register i of a k32 step, byte j, holds the score of the key
    the accumulator layout gives (s[4 j' + e]: key 8 j' + 2 t + (e & 1));
    vt_pos puts that key at byte 4 t + j of the 16 the register covers."""
    pos = _vt_order(64)
    assert sorted(pos) == list(range(64))
    for kc in range(2):
        for t in range(4):
            for reg in range(4):
                base = 16 * kc + (8 if reg >= 2 else 0)
                row_e = 2 if reg % 2 else 0
                idx = [base + row_e, base + row_e + 1, base + 4 + row_e,
                       base + 5 + row_e]               # s[...] packed
                for j, i in enumerate(idx):
                    key = 8 * (i // 4) + 2 * t + (i & 1)
                    assert pos[key] == 32 * kc + (16 if reg >= 2 else 0) \
                        + 4 * t + j


def _codes_model(qkv, heads, hd):
    """The pre-pass in numpy: amax (B, H, nqb + 2), q8, k8 (B, H, sp, hd),
    v8t (B, H, hd, sp) in vt_pos order, zeros past S."""
    b, s, _ = qkv.shape
    qb, sp = min(256, s), attention.i8_pad(s)
    t = qkv.reshape(b, s, 3, heads, hd).transpose(2, 0, 3, 1, 4)
    nqb = -(-s // qb)
    amax = np.zeros((b, heads, nqb + 2), F32)
    q8 = np.zeros((b, heads, sp, hd), np.int8)
    k8 = np.zeros_like(q8)
    v8t = np.zeros((b, heads, hd, sp), np.int8)
    pos = _vt_order(sp)

    def code(v, a):
        return np.clip(np.rint((v * F32(F32(127) / a)).astype(F32)), -127,
                       127).astype(np.int8)

    for i in range(nqb):
        blk = t[0][:, :, i * qb:(i + 1) * qb]
        amax[..., i] = (np.abs(blk).max((-2, -1)) + F32(1e-6)).astype(F32)
        for bi in range(b):
            for h in range(heads):
                q8[bi, h, i * qb:i * qb + blk.shape[2]] = code(
                    blk[bi, h], amax[bi, h, i])
    for j, (dst, v) in enumerate(((k8, t[1]), (None, t[2]))):
        amax[..., nqb + j] = (np.abs(v).max((-2, -1)) + F32(1e-6)).astype(F32)
        for bi in range(b):
            for h in range(heads):
                c = code(v[bi, h], amax[bi, h, nqb + j])
                if dst is not None:
                    dst[bi, h, :s] = c
                else:
                    v8t[bi, h][:, pos[:s]] = c.T
    return amax, q8, k8, v8t


def _main_model(codes, s, heads, hd, scale, natural_v=False):
    """The main pass's order in numpy f32: (B, S, heads hd) bf16 values."""
    amax, q8, k8, v8t = codes
    b = q8.shape[0]
    qb, sp = min(256, s), attention.i8_pad(s)
    nqb = -(-s // qb)
    ntiles = -(-s // 64)
    pos = _vt_order(sp)
    out = np.zeros((b, s, heads, hd), F32)
    log2e = F32(1.4426950408889634)
    for bi in range(b):
        for h in range(heads):
            ak, av = amax[bi, h, nqb], amax[bi, h, nqb + 1]
            acc = (q8[bi, h].astype(np.float64)
                   @ k8[bi, h].astype(np.float64).T)     # exact int32 sums
            for q0 in range(0, sp, 128):
                aq = amax[bi, h, q0 // qb]
                fac2 = F32(F32(F32(F32(aq * ak) / F32(16129)) * F32(scale))
                           * log2e)
                cv = F32(av / F32(16129))
                sc = (acc[q0:q0 + 128].astype(F32) * fac2).astype(F32)
                rows = sc.shape[0]
                m = np.full(rows, -np.inf, F32)
                lt = np.zeros((rows, 4), F32)         # per-thread sums
                for kt in range(ntiles):
                    f = sc[:, kt * 64:(kt + 1) * 64].copy()
                    f[:, np.arange(64) + kt * 64 >= s] = -np.inf
                    tm = np.maximum(m, f.max(-1))
                    lt = (lt * np.exp2((m - tm).astype(F32))[:, None]
                          ).astype(F32)
                    m = tm
                    for j in range(8):
                        for e in range(2):
                            for t in range(4):
                                key = 8 * j + 2 * t + e
                                lt[:, t] = (lt[:, t] + np.exp2(
                                    (f[:, key] - m).astype(F32))).astype(F32)
                lsum = ((lt[:, 0] + lt[:, 1]).astype(F32)
                        + (lt[:, 2] + lt[:, 3]).astype(F32)).astype(F32)
                rl = (F32(1) / lsum).astype(F32)
                ap = (rl + F32(1e-20)).astype(F32)
                inv_ap = (F32(127) / ap).astype(F32)
                osc = (ap * cv).astype(F32)
                keys = ntiles * 64
                e = np.exp2((sc[:, :keys] - m[:, None]).astype(F32))
                p8 = np.rint((((e * rl[:, None]).astype(F32))
                              * inv_ap[:, None]).astype(F32))
                # the A fragments hold the keys at their vt_pos bytes, v8t
                # its keys there; in natural order the bytes mean other keys
                a_pos = np.zeros_like(p8)
                a_pos[:, pos[:keys]] = p8
                vt = v8t[bi, h][:, :keys].astype(np.float64)
                if natural_v:
                    vt = np.zeros_like(vt)
                    vt[:, :s] = v8t[bi, h][:, pos[:s]]
                pv = (a_pos.astype(np.float64) @ vt.T).astype(F32)
                o = (pv * osc[:, None]).astype(F32)
                n_rows = min(128, s - q0)
                if n_rows > 0:
                    out[bi, q0:q0 + n_rows, h] = o[:n_rows]
    return _bf16(out.reshape(b, s, heads * hd))


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


_9B = [(576, 2, 64, 64), (1000, 1, 128, 72), (1024, 1, 64, 64),
       (1024, 1, 128, 72)]


@pytest.mark.parametrize("s,heads,hd,live", _9B)
def test_9b_prepass_model_equals_the_twins_codes(s, heads, hd, live):
    qkv = _qkv(np.random.default_rng(s), 1, s, heads, hd, live)
    amax, q8, k8, v8t = _codes_model(qkv, heads, hd)
    ref = attention.attention_i8_codes_reference(
        torch.from_numpy(qkv).to(torch.bfloat16), heads, hd)
    for got, want in zip((amax, q8, k8, v8t), ref):
        np.testing.assert_array_equal(got, want.numpy())
    # the twin's own codes (attention_qkv_int8_reference's formulas)
    t = torch.from_numpy(qkv).reshape(1, s, 3, heads, hd).permute(
        2, 0, 3, 1, 4)
    ak = torch.amax(t[1].abs(), dim=(-2, -1), keepdim=True) + 1e-6
    np.testing.assert_array_equal(
        k8[:, :, :s], attention._quant_amax(t[1], ak).to(torch.int8).numpy())
    assert not k8[:, :, s:].any() and not q8[:, :, s:].any()
    past = _vt_order(attention.i8_pad(s))[s:]      # keys past S
    assert not v8t[..., past].any()


@pytest.mark.parametrize("s,heads,hd,live", _9B)
def test_9b_main_model_matches_pallas_interpret(s, heads, hd, live):
    qkv = _qkv(np.random.default_rng(s), 1, s, heads, hd, live)
    scale = live ** -0.5
    codes = _codes_model(qkv, heads, hd)
    got = _main_model(codes, s, heads, hd, scale)
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(_compile(lambda v: _attention_qkv_pallas(
        v, heads, hd, scale, interpret=True, int8_attn=True), jq)(jq),
        np.float32)
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    bad = bad.reshape(1, s, heads, hd).any(-1)
    assert not (bad & ~_p8_ties(qkv, heads, hd, scale)).any()
    assert bad.mean() <= 0.01
    # v8t in natural key order: most rows move by more than a bf16 step
    wrong = _main_model(codes, s, heads, hd, scale, natural_v=True)
    apart = np.abs(wrong - want) > _bf16_step(np.maximum(np.abs(wrong),
                                                         np.abs(want)))
    assert apart.reshape(1, s, heads, hd).any(-1).mean() > 0.5


# ------------------------------------------------------- (d) entry points

def test_c_entry_points_and_k5_constants_match_the_sources():
    src = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert "int8_gemm.cu" not in src          # K5 moved to the wgmma GEMM
    for name in _build.SIGNATURES:
        hits = [f for f, t in src.items()
                if re.search(rf"TPUDF_API int {name}\(", t)]
        assert len(hits) == 1, (name, hits)
    # K5's split search (`ln_runs`, with kLnCost) lives in i8_sm90.cuh,
    # which K7's LN phases share
    gemm = (src["int8_gemm_sm90.cu"]
            + (_build.CSRC / "i8_sm90.cuh").read_text())
    assert re.search(r"constexpr int kLnCost = (\d+);", gemm).group(1) == \
        str(int8_block.K5_LN_COST)
    assert re.search(r"constexpr int kLnBN = (\d+);", gemm).group(1) == \
        str(int8_block.K5_TILE)
    # the weight stages beside the panel at W 768 / 832 / 1024 / 1152 / 1280
    assert [int8_block.k5_stages(w) for w in (768, 832, 1024, 1152, 1280)] \
        == [8, 7, 6, 5, 4]
    i8 = src["attention_i8.cu"]
    assert re.search(r"constexpr int kI8Rows = (\d+);", i8).group(1) == \
        str(attention.I8_ROWS)
    assert "attention_i8_amax_kernel" not in i8    # the pre-pass took it
