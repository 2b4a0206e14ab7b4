"""K6 (attention + int8 out-projection) and K7 (the whole W8A8 layer) on
wgmma and TMA (tpudf_torch/csrc/attention.cu, csrc/attn_out_sm90.cuh,
csrc/layer_int8.cu): numpy models of their launch plans, the o panel and
their order against JAX's Pallas kernels in interpret mode and the port's
twins, on the CPU.

  (a) the plan  `int8_block.k6_plan` (a cluster of C CTAs a 128-row tile,
      rank k its heads k, k + C, ... and its 128-column tiles k, k + C,
      ...) at every K6 shape of the paths (the B = 8 towers, the B = 256 /
      128 cores' first layer, B = 256 at 32 tokens) and at phase 2h's
      head widths, on the H100's cluster counts and on another card's:
      every (row tile, head) and every (row tile, column tile) pair once;
      `k6_smem` within a block's 227 KB at every Wa that K6_MAX_WA admits;
      K7's launch (`k7_launch`): its LN phases' units (`k5_units` over its
      blocks), its attention phase's row tiles and its fc2 tiles, each
      output tile once
  (b) K6's tile  the codes of K1's softmax sequence (`k1_tile_model`,
      heads of 16 run zero-padded to 64), written by each CTA of the
      cluster into its panel in the 128-byte swizzle (a 2-byte pair a
      thread) and copied to the others in 16-byte chunks, read back
      through wgmma's K-major descriptor (the address bits 4-6 XOR bits
      7-9): the codes exactly, every panel alike; then the out-projection
      split over the ranks' column tiles with the GEMM's epilogue op by op:
      against JAX's `attn_out_int8(interpret=True)` at (2, 64, 3 x 128 ->
      128) by K1's CPU rule (5e-2), and, on the twin's codes
      (`attention_i8_reference`), bit-equal to the int8 GEMM's twin epilogue
  (c) K7's phases  LN1 codes by the kernel's statistics (K5's panel), the
      QKV product rounded to bf16, the attention (K9's exact softmax), the
      out-projection into the f32 x1 = (x + acc cs) + b, LN2 over the f32
      rows of x1 in the same order, fc1 + GELU + quant, fc2 + the f32
      residual (before the kernel's last rounding to bf16): against
      `siglip_layer_int8(interpret=True)` at (2, 64, 128), MLP 256, f32 x,
      by `test_k7_twin_matches_pallas_interpret`'s tolerance (2e-3, rows
      with a flipped LN1 code excepted)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_k1_sm90 import _bf16, k1_tile_model
from tests.test_torch_port_k5_9b_sm90 import _ln_codes_model, _read_k_major
from tests.test_torch_port_variants import (_compile, _flipped_rows, _qw,
                                            _t, _tree_t, _vec)
from tpudf.ops import int8_block as J_int8
from tpudf_torch.ops import attention, int8_block, quant
from tpudf_torch.utils.nn import gelu_tanh

F32 = np.float32
SMEM = 232448
# another card's cluster counts (fewer SMs; clusters that GPCs' SMs do not
# divide fewer)
OTHER_CLUSTERS = {1: 114, 2: 57, 3: 34, 4: 27, 5: 19, 6: 15, 7: 14, 8: 14}


# ------------------------------------------------------------ (a) the plan

# (B, S, heads, head_dim): the B = 8 towers of base-256 and large-384
# without ToMe, the B = 256 / 128 cores' first layer, B = 256 at 32
# tokens, phase 2h's widths (W 768), a narrow head padded to 16
K6_PATHS = [(8, 256, 12, 64), (8, 576, 16, 64), (256, 256, 12, 64),
            (128, 576, 16, 64), (256, 32, 12, 64), (8, 576, 48, 16),
            (8, 584, 24, 32), (8, 576, 6, 128), (8, 584, 3, 256),
            (2, 64, 16, 8)]


@pytest.mark.parametrize("waves", [None, OTHER_CLUSTERS],
                         ids=["h100", "other-card"])
@pytest.mark.parametrize("b,s,heads,hd", K6_PATHS,
                         ids=[f"{b}x{s}-{h}x{d}" for b, s, h, d in K6_PATHS])
def test_k6_plan_covers_each_pair_once(b, s, heads, hd, waves):
    tile, live = int8_block.k6_tile(hd)
    w = heads * hd
    plan = int8_block.k6_plan(b, s, heads, tile, live, w, waves)
    c = int8_block.k6_cluster(b, s, heads, tile, live, w, waves)
    n_qt = -(-s // 128)
    assert 1 <= c <= min(8, heads) and len(plan) == b * n_qt * c
    head_seen = np.zeros((b, n_qt, heads), np.int64)
    tile_seen = np.zeros((b, n_qt, w // 128), np.int64)
    for img, q0, rank, hs, tiles in plan:
        assert q0 % 128 == 0 and q0 < s and 0 <= rank < c
        for h in hs:
            head_seen[img, q0 // 128, h] += 1
        for tn in tiles:
            tile_seen[img, q0 // 128, tn] += 1
    assert (head_seen == 1).all() and (tile_seen == 1).all()
    # the heads of a CTA differ by at most one across its cluster
    counts = [len(hs) for *_, hs, _ in plan]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("name,b,s,heads,want", [
    ("base-256", 8, 256, 12, 6), ("large-384", 8, 576, 16, 8),
    ("base-256", 256, 256, 12, 1), ("large-384", 128, 576, 16, 1)])
def test_k6_cluster_size_at_the_paths(name, b, s, heads, want):
    """The cluster size at the cores' shapes on the H100's counts: at B = 8
    6 at base-256 (16 row tiles in one wave of 17, two heads a CTA; 4 and
    8 timed slower on the card) and 8 at large-384 (40 row tiles in three
    waves of 15, two heads a CTA); 1 where the row tiles fill the card."""
    c = int8_block.k6_cluster(b, s, heads, 64, 64, heads * 64)
    assert c == want
    print(f"K6 {name} B={b}: clusters of {c}, "
          f"{-(-b * -(-s // 128) // int8_block.H100_CLUSTERS[c])} waves")


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_k6_smem_fits_every_wa(hd):
    tile, live = int8_block.k6_tile(hd)
    limit = int8_block.K6_MAX_WA[live]
    for wa in range(64, limit + 1, 64):
        smem = int8_block.k6_smem(tile, wa)
        assert smem is not None and smem <= SMEM, (hd, wa, smem)
    # the panel grows with Wa, in 16 KB slices
    assert (int8_block.k6_smem(tile, limit)
            >= int8_block.k6_smem(tile, 64) + (limit // 128 - 1) * 16384
            - 6 * 2 * 64 * tile * 2)
    # the smallest shapes K6's launch counted on the card (PR 15's run)
    assert int8_block.k6_smem(64, 768) == 214240
    assert int8_block.k6_smem(64, 1024) == 230592


@pytest.mark.parametrize("b,s", [(8, 256), (256, 32), (2, 64)])
def test_k7_launch_covers_each_tile_once(b, s):
    w, heads, inter = 768, 12, 3072
    c, blocks, runs1, runs3 = int8_block.k7_launch(b, s, heads, w, inter)
    m = b * s
    assert blocks % c == 0 and blocks <= int8_block.H100_SMS
    for n, runs in ((3 * w, runs1), (inter, runs3)):
        assert runs == int8_block.k5_splits(m, n, blocks)
        seen = np.zeros((-(-m // 128), n // 128), np.int64)
        for block in int8_block.k5_units(m, n, blocks):
            for rt, t0, t1 in block:
                seen[rt, t0:t1] += 1
        assert (seen == 1).all()
    # the attention phase: clusters walk the row tiles of every image
    clusters, units = blocks // c, b * -(-s // 128)
    walked = sorted(u for k in range(clusters)
                    for u in range(k, units, clusters))
    assert walked == list(range(units))
    # fc2: output tiles of 128 x 128 over the blocks
    tiles = -(-m // 128) * (w // 128)
    walked = sorted(u for k in range(blocks) for u in range(k, tiles, blocks))
    assert walked == list(range(tiles))


# ------------------------------------------------------------ (b) K6's tile

def _panel_at(pr, col):
    """The byte of panel column col in panel row pr (attn_out_sm90.cuh
    `panel_at`)."""
    return ((col // 128) * 16384 + pr * 128
            + ((((col % 128) >> 4) ^ (pr & 7)) << 4) + (col & 15))


def _k6_panels(codes, q0, s, heads, live, c):
    """The C panels of the cluster at row tile q0 of one image's codes (S,
    heads live): rank k writes its heads' codes of rows below S into its
    own panel a thread's 2-byte pair at a time, then copies its heads'
    16-byte chunks of those rows into the other ranks' panels; the
    other bytes stale."""
    wa = heads * live
    nk = -(-wa // 128)
    panels = [np.full(nk * 16384, 0x5A, np.uint8) for _ in range(c)]
    rows = min(128, s - q0)
    for k in range(c):
        for h in range(k, heads, c):
            for pr in range(rows):
                for j in range(0, live, 2):
                    col = h * live + j
                    at = _panel_at(pr, col)
                    panels[k][at:at + 2] = codes[q0 + pr,
                                                 col:col + 2].view(np.uint8)
        for h in range(k, heads, c):
            for pr in range(rows):
                for ch in range(live // 16):
                    at = _panel_at(pr, h * live + 16 * ch)
                    for d in range(1, c):
                        panels[(k + d) % c][at:at + 16] = panels[k][at:at + 16]
    return panels


def _epilogue(acc, res, cs, bias, act):
    """The GEMM's GEMM_RESIDUAL epilogue op by op in f32: a_div = act / 127,
    cs' = a_div cs, f = acc cs' + b, out = bf16(res + f)."""
    a_div = F32(F32(act) / F32(127.0))
    f = ((acc.astype(F32) * (a_div * cs).astype(F32)).astype(F32)
         + bias).astype(F32)
    return _bf16((res + f).astype(F32))


def k6_tile_model(codes, x, wt, cs, bias, act, b, s, heads, live, c):
    """K6's tile from given codes (B S, heads live): per row tile the
    cluster's panels (all alike), read back through wgmma's descriptor, and
    each rank's 128-column tiles of the out-projection, exact int sums and
    the epilogue; (B, S, W) f32 of bf16 values."""
    wa, w = heads * live, wt.shape[0]
    nk = -(-wa // 128)
    wp = np.zeros((w, nk * 128), np.int64)
    wp[:, :wa] = wt
    out = np.zeros((b, s, w), F32)
    for img in range(b):
        img_codes = codes[img * s:(img + 1) * s]
        for q0 in range(0, s, 128):
            panels = _k6_panels(img_codes, q0, s, heads, live, c)
            reads = [_read_k_major(p, nk) for p in panels]
            rows = min(128, s - q0)
            for rd in reads:
                np.testing.assert_array_equal(rd[:rows, :wa],
                                              img_codes[q0:q0 + rows])
            for k in range(c):
                a = reads[k][:rows].astype(np.int64)
                for tn in range(k, w // 128, c):
                    cols = slice(128 * tn, 128 * tn + 128)
                    acc = a @ wp[cols].T
                    out[img, q0:q0 + rows, cols] = _epilogue(
                        acc, x[img, q0:q0 + rows, cols], cs[cols],
                        bias[cols], act)
    return out


# (heads, head_dim) at W = 128: heads of 64 as they are; heads of 16 and 8
# zero-padded (to 64 for the attention, 8 to 16 for the panel)
K6_MODEL = [(2, 64), (8, 16), (16, 8)]


@pytest.mark.parametrize("heads,hd", K6_MODEL,
                         ids=[f"{h}x{d}" for h, d in K6_MODEL])
def test_k6_tile_model_matches_pallas_interpret(heads, hd):
    rng = np.random.default_rng(300 + hd)
    b, s, w = 2, 64, 128
    tile, live = int8_block.k6_tile(hd)
    qkv = _bf16(rng.normal(0, 1.5, (b, s, 3 * w)).astype(F32))
    x = _bf16(rng.normal(0, 1, (b, s, w)).astype(F32))
    wq, bias = _qw(rng, w, w), _vec(rng, w)
    act, scale = F32(2.0), hd ** -0.5
    want = np.asarray(_compile(lambda q, r: J_int8.attn_out_int8(
        q, r, {k: jnp.asarray(a) for k, a in wq.items()}, jnp.asarray(bias),
        2.0, heads, hd, interpret=True), qkv, x)(qkv, x))
    # K1's softmax sequence on the padded tile; the panel's live columns
    qt = torch.from_numpy(qkv)
    padded = attention.pad_heads(qt, heads, hd, tile).numpy()
    codes = k1_tile_model(padded, heads, tile, scale, act)
    codes = attention.unpad_heads(torch.from_numpy(codes), heads, hd,
                                  tile).numpy()
    wt = wq["q"].T.astype(np.int64)
    if live != hd:
        wt = attention.pad_heads(torch.from_numpy(wt), heads, hd,
                                 live).numpy()
        codes = attention.pad_heads(torch.from_numpy(codes), heads, hd,
                                    live).numpy()
    c = int8_block.k6_cluster(b, s, heads, tile, live, w)
    for c_ in sorted({1, c, min(4, heads)}):
        got = k6_tile_model(codes, x, wt, wq["scale"], bias, act, b, s,
                            heads, live, c_)
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    # on the twin's codes, bit-equal to the int8 GEMM's twin epilogue
    twin = int8_block.attention_i8_reference(
        qt.to(torch.bfloat16), heads, hd, torch.tensor(act), scale)
    tc = twin.numpy()
    if live != hd:
        tc = attention.pad_heads(twin, heads, hd, live).numpy()
    got = k6_tile_model(tc, x, wt, wq["scale"], bias, act, b, s, heads,
                        live, c)
    acc = quant.int8_mm(twin, torch.from_numpy(wq["q"])).float()
    ref = (torch.from_numpy(x).reshape(b * s, w) + (
        acc * ((torch.tensor(act) / 127.0) * torch.from_numpy(wq["scale"]))
        + torch.from_numpy(bias))).to(torch.bfloat16).float()
    np.testing.assert_array_equal(got.reshape(b * s, w), ref.numpy())


# ------------------------------------------------------------ (c) K7's phases

W, HEADS, HD, INTER = 128, 2, 64, 256


def _int8(codes_rows, wq, a, bias):
    """acc of codes (M, K) against wq {q: (K, N)}, dequantised + bias, f32
    op by op as the epilogues."""
    acc = (codes_rows.astype(np.int64) @ wq["q"].astype(np.int64))
    a_div = F32(F32(a) / F32(127.0))
    return acc, (a_div * wq["scale"]).astype(F32)


def k7_phase_model(x, bp):
    """K7's four phases in numpy f32, in the kernel's order: x (B, S, W) ->
    x1 + fc2's f32 output, the value the kernel's last op rounds to bf16
    (JAX's interpret run at f32 x returns it unrounded)."""
    b, s, w = x.shape
    m = b * s
    sc = bp["act_scales"]
    at, ml = bp["attn"], bp["mlp"]
    xr = x.reshape(m, w)
    # 1. LN1 codes (K5's panel), QKV, bf16
    q8 = _ln_codes_model(xr, bp["ln1"]["scale"], bp["ln1"]["bias"],
                         sc["qkv"])
    acc, cs = _int8(q8, at["qkv_w"], sc["qkv"], None)
    qkv = _bf16(((acc.astype(F32) * cs).astype(F32)
                 + at["qkv_b"]).astype(F32)).reshape(b, s, 3 * w)
    # 2. attention (K9's exact softmax, f32 o), codes, out-projection into
    # the f32 x1 = (x + acc cs) + b
    o = attention.attention_qkv_reference(
        torch.from_numpy(qkv).to(torch.bfloat16), HEADS, HD,
        out_dtype=torch.float32).numpy().reshape(m, w)
    o8 = quant.quant_rows(torch.from_numpy(o),
                          torch.tensor(sc["out"])).numpy()
    acc, cs = _int8(o8, at["out_w"], sc["out"], None)
    x1 = ((xr + (acc.astype(F32) * cs).astype(F32)).astype(F32)
          + at["out_b"]).astype(F32)
    # 3. LN2 over the f32 rows of x1, fc1 + GELU + quant
    q1 = _ln_codes_model(x1, bp["ln2"]["scale"], bp["ln2"]["bias"],
                         sc["fc1"])
    acc, cs = _int8(q1, ml["fc1_w"], sc["fc1"], None)
    f1 = ((acc.astype(F32) * cs).astype(F32) + ml["fc1_b"]).astype(F32)
    g = gelu_tanh(torch.from_numpy(f1)).numpy()
    h8 = np.clip(np.rint((g * F32(F32(127) / F32(sc["fc2"]))).astype(F32)),
                 -127, 127).astype(np.int8)
    # 4. fc2 + the f32 residual x1 -> bf16
    acc, cs = _int8(h8, ml["fc2_w"], sc["fc2"], None)
    f2 = ((acc.astype(F32) * cs).astype(F32) + ml["fc2_b"]).astype(F32)
    return (x1 + f2).astype(F32).reshape(b, s, w)


def test_k7_phase_model_matches_pallas_interpret():
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 64, W)).astype(F32)
    bp = {"ln1": {"scale": _vec(rng, W, 1.0), "bias": _vec(rng, W)},
          "ln2": {"scale": _vec(rng, W, 1.0), "bias": _vec(rng, W)},
          "attn": {"qkv_w": _qw(rng, W, 3 * W), "qkv_b": _vec(rng, 3 * W),
                   "out_w": _qw(rng, W, W), "out_b": _vec(rng, W)},
          "mlp": {"fc1_w": _qw(rng, W, INTER), "fc1_b": _vec(rng, INTER),
                  "fc2_w": _qw(rng, INTER, W), "fc2_b": _vec(rng, W)},
          "act_scales": {k: F32(v) for k, v in
                         (("qkv", 3.0), ("out", 2.0), ("fc1", 3.0),
                          ("fc2", 2.0))}}
    jbp = jax.tree.map(jnp.asarray, bp)
    want = np.asarray(_compile(lambda v, p: J_int8.siglip_layer_int8(
        v, p, HEADS, HD, interpret=True), x, jbp)(x, jbp))
    got = k7_phase_model(x, bp)
    flipped = _flipped_rows(x, bp["ln1"]["scale"], bp["ln1"]["bias"],
                            3.0).reshape(2, 64)
    assert flipped.mean() <= 0.01
    np.testing.assert_allclose(got[~flipped], want[~flipped], atol=2e-3,
                               rtol=2e-3)
    # the port's twin agrees with the model at the same tolerance
    twin = int8_block.siglip_layer_int8(_t(x), _tree_t(bp), HEADS,
                                        HD).numpy()
    np.testing.assert_allclose(got[~flipped], twin[~flipped], atol=2e-3,
                               rtol=2e-3)
