"""The quantising probe GEMMs on the int8 wgmma kernel (kernel 15's
`int8_kernel`, kernel 16's `k_full`, `k_nogelu` and `k_bf16_epi`;
tpudf_torch/csrc/int8_gemm_sm90.cu's quant panel, `tpudf_i8_gemm_quant`,
and its split form): numpy models of the kernel's layout, walk and order
against the port's twins and JAX, on the CPU.

    python -m pytest tests/test_torch_port_probe_sm90.py -q

  (a) the panel  a numpy model of how the codes reach the panel: x's bf16
      boxes of 128 rows x 64 columns as TMA writes them (128-byte swizzle,
      zeros past M), quantised by `quant_box`'s threads into the panel's
      swizzled slices, read back K-major as wgmma's descriptor reads them:
      the codes equal `common.quant_codes` and JAX's `jnp.round` codes at K
      768, 832 and 1280 (a 64-deep tail); the columns past K keep what the
      panel held before and add nothing against the weight's zero-filled
      tail; the shared-memory budget (the panel, the slots, three 32 KB
      stages) holds to K = PANEL_MAX_K and no further
  (b) the walk  `common.quant_units` at both probes' shapes, at a ragged
      N % 256 = 128 and at a small M: every (row tile, column tile) once,
      each from its own row tile's panel, each row of x quantised once a
      run (once at the probes' shapes)
  (c) the epilogues  the kernel's op order (`probe_value`, and kEpiBf16's)
      in numpy f32 on exact int32 sums against the JAX scripts' own
      Pallas bodies (`int8_kernel`, `k_full`, `k_nogelu`, `k_bf16_epi`) in
      interpret mode at (M, K, N) = (512, 320, 384), by PROBE_TOL's steps
      (one bf16 step; k_full + 1e-6; k_bf16_epi two steps); each model
      bit-equal to the port's twin
  (d) the routes  one launch at K <= 768, the split form past it, both
      inside `check_gemm`'s unchanged domain (K % 64 == 0, K <= 1600) at K
      768, 1280, 1344 and 1600; the launches each route makes (the C
      entry points recorded on meta tensors), its mode the same in both
      forms; the C constants equal the Python ones
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scripts.micro_epilogue as J16
import scripts.micro_pallas_int8 as J15
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tests.test_torch_port_k5_9b_sm90 import _read_k_major
from tpudf_torch.ops import _build
from tpudf_torch.probes import common
from tpudf_torch.probes import micro_epilogue as P16
from tpudf_torch.probes import micro_pallas_int8 as P15
from tpudf_torch.utils.nn import gelu_tanh

F32 = np.float32
SMEM = 232448                   # a block's shared memory on sm_90


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def _quant(x):
    """The kernel's `quant8`: clip(rint(f32(x) · (127 / 4)), ±127)."""
    return np.clip(np.rint((x.astype(F32) * F32(common.INV_ACT)).astype(
        F32)), -127, 127).astype(np.int8)


# ------------------------------------------------------------ (a) the panel

def _tma_box(x, m0, c0):
    """The 128 x 64 bf16 box of x at (m0, c0) as TMA lays it in shared
    memory: 128 rows of 128 bytes, a row's 16-byte chunk c at c ^ (row %
    8), zeros past M (as f32 values, 8 a chunk)."""
    box = np.zeros((128, 8, 8), F32)
    rows = x[m0:m0 + 128, c0:c0 + 64]
    for r in range(rows.shape[0]):
        for c in range(8):
            box[r, c ^ (r & 7)] = rows[r, 8 * c:8 * c + 8]
    return box


def _panel_model(x, m0, k, stale=0x55):
    """The panel of the row tile at m0 as `quant_box` writes it from the
    unit's boxes (ceil(K / 64) of them): thread t of warpgroup wg takes
    group g = t % 8 of rows wg 64 + t / 8 + 16 q, reads its chunk g ^ (row
    % 8) of the box, and writes 8 codes at byte (col % 128) of its panel
    row, chunk (col % 128) / 16 at chunk ^ (row % 8); the panel held
    `stale` bytes before."""
    nk = -(-k // 128)
    panel = np.full(nk * 16384, stale, np.uint8)
    for b in range(-(-k // 64)):
        c0 = 64 * b
        box = _tma_box(x, m0, c0)
        for wg in range(2):
            for t in range(128):
                g = t & 7
                col = c0 % 128 + 8 * g
                for q in range(4):
                    row = wg * 64 + t // 8 + 16 * q
                    codes = _quant(box[row, g ^ (row & 7)])
                    at = (c0 // 128 * 16384 + row * 128
                          + (((col >> 4) ^ (row & 7)) << 4) + (col & 15))
                    panel[at:at + 8] = codes.view(np.uint8)
    return panel


@pytest.mark.parametrize("m,k", [(300, 768), (200, 832), (130, 1280)])
def test_panel_model_holds_the_codes(m, k):
    rng = np.random.default_rng(m + k)
    # N(0, 2) with rounding ties of x · 31.75 mixed in
    x = rng.standard_normal((m, k)) * 2.0
    x.flat[::7] = (rng.integers(-140, 140, x.size)[::7] + 0.5) / 31.75
    x = _bf16(x)
    nk = -(-k // 128)
    got = np.zeros((-(-m // 128) * 128, nk * 128), np.int8)
    for m0 in range(0, m, 128):
        got[m0:m0 + 128] = _read_k_major(_panel_model(x, m0, k), nk)
    want = common.quant_codes(torch.from_numpy(x).to(torch.bfloat16),
                              common.INV_ACT).numpy().astype(np.int8)
    jax_codes = np.asarray(jnp.clip(jnp.round(
        jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) * (127.0 / 4.0)),
        -127, 127))
    np.testing.assert_array_equal(want, jax_codes)
    np.testing.assert_array_equal(got[:m, :k], want)
    assert (got[m:, :k] == 0).all()                   # rows past M
    if k % 128:                                       # the stale tail
        assert (got[:, k:] == np.int8(0x55)).all()
        wt = rng.integers(-127, 128, (256, k)).astype(np.int64)
        wpad = np.zeros((256, nk * 128), np.int64)    # TMA's zero fill
        wpad[:, :k] = wt
        np.testing.assert_array_equal(got[:m].astype(np.int64) @ wpad.T,
                                      want.astype(np.int64) @ wt.T)


def _quant_stages(k):
    """The weight stages the one launch's block holds at depth k: the
    panel (ceil(k / 128) slices of 16 KB), two 8 KB slots a consumer, the
    alignment and barriers, 32 KB a stage (`quant_stages`)."""
    room = SMEM - -(-k // 128) * 16384 - 2 * 2 * 8192 - 1024 - 16
    return min(8, room // (common.QUANT_TILE * 128 + 16))


def test_panel_budget_ends_at_panel_max_k():
    assert _quant_stages(common.PANEL_MAX_K) == 3
    assert _quant_stages(common.PANEL_MAX_K + 64) < 3
    assert _quant_stages(common.MAX_K) < 2       # 1600: no panel fits


# ------------------------------------------------------------ (b) the walk

@pytest.mark.parametrize("m,n", [(16384, 3072), (65536, 3072),
                                 (65536, 3200), (1000, 384)])
def test_walk_covers_every_tile_once_from_its_own_panel(m, n):
    walk = common.quant_units(m, n)
    rows, tiles = -(-m // 128), -(-n // common.QUANT_TILE)
    assert 1 <= len(walk) <= 132
    seen = np.zeros((rows, tiles), np.int64)
    builds = np.zeros(rows, np.int64)
    for block in walk:
        for rt, run in block:
            panel = rt                      # built at the unit's start
            builds[rt] += 1
            assert sorted(run) == list(range(min(run), max(run) + 1))
            for tn in run:
                assert panel == rt
                seen[rt, tn] += 1
    assert (seen == 1).all()
    assert (builds == builds[0]).all()      # once a run: the split
    if n == 3072 and m >= 16384:            # the probes' shapes
        assert (builds == 1).all()
        # the blocks start their runs at different column tiles
        firsts = [block[0][1][0] for block in walk]
        assert len(set(firsts)) == tiles


# ------------------------------------------------------------ (c) epilogues

EM, EK, EN = 512, 320, 384


def _epilogue_model(variant, acc, s, b):
    """The kernel's epilogue in numpy f32, op for op: a_div = 4 / 127
    (the IEEE division), kEpiProbeStatic (acc a_div) s, kEpiBf16 acc (a_div
    s) + b, kEpiProbeGelu GELU of it, kEpiProbeBf16 bf16(bf16(bf16(acc)
    bf16(s)) + bf16(b)); rounded to bf16 (as f32 values)."""
    a = acc.astype(F32)
    a_div = F32(4.0) / F32(127.0)
    if variant == "staticq":
        return _bf16((a * a_div).astype(F32) * s)
    if variant == "bf16_epi":
        return _bf16((_bf16(_bf16(a) * _bf16(s)) + _bf16(b)).astype(F32))
    f = ((a * (a_div * s).astype(F32)).astype(F32) + b).astype(F32)
    if variant == "full":
        f = gelu_tanh(torch.from_numpy(f)).numpy()
    return _bf16(f)


def _steps(got, want, steps, atol):
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(
        np.abs(got), np.abs(want)), 1e-30))) - 7)
    return bool((np.abs(got - want) <= steps * step + atol).all())


@pytest.mark.parametrize("variant", ["staticq", "full", "nogelu",
                                     "bf16_epi"])
def test_epilogue_order_matches_pallas_body(variant):
    rng = np.random.default_rng(17)
    x = _bf16(rng.standard_normal((EM, EK)))
    w = rng.integers(-127, 128, (EK, EN)).astype(np.int8)
    s = (rng.random(EN) * 0.01 + 0.01).astype(F32)
    b = rng.random(EN).astype(F32)
    acc = _quant(x).astype(np.int64) @ w.astype(np.int64)
    got = _epilogue_model(variant, acc, s, b)
    xj = jnp.asarray(x, jnp.bfloat16)
    if variant == "staticq":
        want = pl.pallas_call(J15.int8_kernel, out_shape=jax.ShapeDtypeStruct(
            (EM, EN), jnp.bfloat16), interpret=True)(xj, w, s[None])
    else:
        body = {"full": J16.k_full, "nogelu": J16.k_nogelu,
                "bf16_epi": J16.k_bf16_epi}[variant]
        want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(
            (EM, EN), jnp.bfloat16), interpret=True)(xj, w, s[None],
                                                     b[None])
    want = np.asarray(want, F32)
    steps, atol = {"full": (1, 1e-6), "bf16_epi": (2, 0.0)}.get(variant,
                                                                (1, 0.0))
    assert _steps(got, want, steps, atol)
    # the model is the port's twin, bit for bit
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w.T.copy())
    if variant == "staticq":
        twin = P15.int8_matmul_staticq_reference(xt, wt, torch.from_numpy(s))
    else:
        twin = P16.fc1_matmul_reference(variant, xt, wt, torch.from_numpy(s),
                                        torch.from_numpy(b))
    np.testing.assert_array_equal(got, twin.float().numpy())


def test_dequant_factor_is_the_ieee_quotient():
    """The kernel's act / 127 (`div_rn`: the IEEE quotient of f32 4 and
    127) is the probes' f32(4 / 127), rounded once from the double."""
    assert float(F32(4.0) / F32(127.0)) == common.C_ACT


# ------------------------------------------------------------ (d) routes

@pytest.mark.parametrize("k,route", [(64, "one"), (768, "one"),
                                     (832, "split"), (1280, "split"),
                                     (1344, "split"), (1600, "split")])
def test_route_inside_the_unchanged_domain(k, route):
    assert common.quant_route(k) == route
    x = torch.empty((512, k), dtype=torch.bfloat16, device="meta")
    wt = torch.empty((384, k), dtype=torch.int8, device="meta")
    common.check_gemm("probe", x, wt, torch.bfloat16, 64,
                      max_k=common.MAX_K)        # the parent's domain


@pytest.mark.parametrize("k", [1601, 1664, 800])
def test_domain_refuses_past_it(k):
    x = torch.empty((512, k), dtype=torch.bfloat16, device="meta")
    wt = torch.empty((384, k), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        common.check_gemm("probe", x, wt, torch.bfloat16, 64,
                          max_k=common.MAX_K)


@pytest.mark.parametrize("mode", list(common.QUANT_MODES))
@pytest.mark.parametrize("k", [768, 1600])
def test_route_launches(mode, k, monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda name, *a: calls.append(
        (name, a)))
    x = torch.empty((512, k), dtype=torch.bfloat16, device="meta")
    wt = torch.empty((384, k), dtype=torch.int8, device="meta")
    s = torch.empty((384,), device="meta")
    b = None if mode == "staticq" else torch.empty((384,), device="meta")
    for split in (False, True):
        calls.clear()
        out = (common.quant_gemm_split if split else common.quant_gemm_cuda)(
            mode, x, wt, s, b, None)
        assert out.shape == (512, 384) and out.dtype == torch.bfloat16
        names = [c[0] for c in calls]
        if k <= common.PANEL_MAX_K and not split:
            assert names == ["tpudf_i8_gemm_quant"]
            assert calls[0][1][-1] == common.QUANT_MODES[mode]
            continue
        assert names == ["tpudf_quant_rows_i8", "tpudf_i8_gemm"]
        codes = calls[0][1][2]
        assert codes.dtype == torch.int8 and codes.shape == (512, k)
        assert calls[1][1][0] is codes
        assert calls[1][1][-1] == common.QUANT_MODES[mode]


def test_c_constants_match():
    src = (_build.CSRC / "int8_gemm_sm90.cu").read_text()
    enum = (_build.CSRC / "gemm_i8.cuh").read_text()
    assert re.search(r"constexpr int kQuantPanelMaxK = (\d+);", src).group(
        1) == str(common.PANEL_MAX_K)
    assert re.search(r"constexpr int kQuantBN = (\d+);", src).group(1) == \
        str(common.QUANT_TILE)
    modes = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"(kEpi\w+) = (\d+),", enum)}
    assert common.QUANT_MODES == {"staticq": modes["kEpiProbeStatic"],
                                  "full": modes["kEpiProbeGelu"],
                                  "nogelu": modes["kEpiBf16"],
                                  "bf16_epi": modes["kEpiProbeBf16"]}
    assert not (_build.CSRC / "probe_gemm.cu").exists()
    assert P15.KERNEL_INT8_SPLIT != P15.KERNEL_INT8
    assert set(P16.KERNELS_SPLIT) == set(P16.QUANTISED)

