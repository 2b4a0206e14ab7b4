"""Kernel 17 (the static-scale int8 attention probe) on 9b's int8 wgmma +
TMA pass (tpudf_torch/csrc/attention_i8.cu: the pre-pass's static mode
`attention_i8_prepass<true>`, the codes of k and v, and
`attention_i8dyn_sm90<128, true>`, which quantises q itself): numpy models
of its two launches against the port's twin and JAX's probe
(scripts/micro_attn_static.py's `static_variant`, its Pallas kernel in
interpret mode; nothing in scripts/ is edited), on the CPU.

    python -m pytest tests/test_torch_port_k17_sm90.py -q

  (a) the main pass's order  a numpy model of the kernel: items of 128
      query rows, 64-key tiles, the first sweep's integer row max M of q8
      . k8 (keys past S out of it), one exp2 a score in the second sweep
      of (s - M) fac log2 e rounded once, e added to per-thread sums in the
      kernel's key order and reduced over the quad, p8 = rint(127 e) half
      to even (one rounding) against v8t in `vt_pos` order, o = f32(int32
      p8 . v8) (1 / l + 1e-20) cv, bf16. Held against
      JAX at (B, S) = (1, 300), (2, 256) and (1, 1000) with 2 heads of 128
      by test_torch_port_probes.py's rule for kernel 17 (one bf16 step,
      but in rows with a probability code within 1e-3 of a tie; at most
      1 % of the rows)
  (b) the max  at every row, f32(integer max) fac equals JAX's f32 row max
      of its scores bit for bit, so JAX's largest e, exp(0), is the
      kernel's 2^0; the kernel's float 2^23 + (s - M), built as the bits
      2 s + 0x4B000000 - 2 M, is exact over the whole range of s - M
  (c) the ragged-S traps  at S = 300 with q rows = -(k rows), every real
      score of a row negative: the model holds to JAX; a model whose max
      takes the zero scores of the keys past S, and one that adds those
      keys' e to l, do not
  (d) the codes  a numpy model of the pre-pass's grid (block z: 128 rows
      of k or v, z % 2) writes each row of k8 and v8t once; the main
      pass's q8: an item's q as four bf16 boxes laid out as TMA lays them
      (the 128-byte swizzle, rows past S zero), quantised as `quant_q`
      writes the q8 tile and read back as wgmma's K-major descriptor
      reads it; all codes equal `static_codes_reference`,
      `common.quant_codes` and JAX's `jnp.round` codes in 9b's layouts
      (zeros past S, v8t's keys at `vt_pos`)
  (e) the domain  `static_fits` holds wherever the parent's `check_static`
      did (S 1, 300, 1024, 131072), for every qkv that fits in 80 GB, and
      matches the C side's limits; p8 . v8 stays under 2^31
  (f) the entry points  every C signature of `_build.SIGNATURES` matches
      its definition argument for argument; the wrapper's two launches
      (recorded on meta tensors) pass the codes from the first to the
      second and count each on its own counter
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tests.test_torch_port_k5_9b_sm90 import _read_k_major
from tests.test_torch_port_probes import J17, _bf16, _bf16_step, _p8_ties
from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.ops import _build
from tpudf_torch.ops.attention import MAX_ROWS, MAX_SEQ, i8_pad, vt_pos
from tpudf_torch.probes import common
from tpudf_torch.probes import micro_attn_static as P17

F32 = np.float32
LOG2E = F32(1.4426950408889634)
HEADS, HD = 2, 128
INT_MIN = np.iinfo(np.int32).min


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    """The probe's pallas_call in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _qkv(b, s, seed, negative=False):
    """bf16-rounded f32 (B, S, 3 HEADS HD); negative: k rows a shared
    vector plus noise and q = -k, so every real score is negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, 3, HEADS, HD))
    if negative:
        k = rng.standard_normal((1, 1, HEADS, HD)) + 0.3 * x[:, :, 1]
        x[:, :, 1], x[:, :, 0] = k, -k
    return _bf16(x.reshape(b, s, 3 * HEADS * HD))


def _code(x, inv):
    return np.clip(np.rint((x * F32(inv)).astype(F32)), -127, 127).astype(
        np.int8)


def _heads(qkv):
    """(B, S, 3 H d) -> q, k, v as (B, H, S, d) f32."""
    b, s, _ = qkv.shape
    t = qkv.reshape(b, s, 3, HEADS, HD).transpose(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _prepass_model(qkv, c):
    """The pre-pass's grid in numpy: block z codes rows 128 (z // 2) ..
    + 127 of k or v (z % 2), zeros past S; v's keys at vt_pos. Returns
    (k8, v8t, writes: times each row of k and v was written)."""
    b, s, _ = qkv.shape
    sp = i8_pad(s)
    _, k, v = _heads(qkv)
    k8 = np.full((b, HEADS, sp, HD), 77, np.int8)     # torch.empty's garbage
    v8t = np.full((b, HEADS, HD, sp), 77, np.int8)
    pos = np.array([vt_pos(x) for x in range(sp)])
    writes = np.zeros((2, sp), int)
    for z in range(2 * sp // 128):
        part, r0 = z % 2, z // 2 * 128
        r1 = min(s, r0 + 128)
        codes = np.zeros((b, HEADS, 128, HD), np.int8)
        codes[:, :, :r1 - r0] = _code((k, v)[part][:, :, r0:r1],
                                      (c["inv_k"], c["inv_v"])[part])
        writes[part, r0:r0 + 128] += 1
        if part:
            v8t[..., pos[r0:r0 + 128]] = codes.transpose(0, 1, 3, 2)
        else:
            k8[:, :, r0:r0 + 128] = codes
    return k8, v8t, writes


def _q8_model(qkv, c):
    """The main pass's q8 in numpy, item by item: the item's 128 rows of a
    head's q (zeros past S) as TMA's four boxes of 64 rows x 64 columns
    (box (rows / 64, columns / 64) 8 KB apart, a row's 16-byte chunk g at
    g ^ (row % 8)); `quant_q`'s threads (8 columns each: row i / 16,
    columns 8 (i % 16)) code each box chunk into the q8 tile (row r's
    chunk j at j ^ (r % 8)); wgmma reads the tile K-major. Returns (B, H,
    S_pad, 128) int8."""
    b, s, _ = qkv.shape
    sp = i8_pad(s)
    q = np.zeros((b, HEADS, sp, HD), F32)
    q[:, :, :s] = _heads(qkv)[0]
    q8 = np.zeros((b, HEADS, sp, HD), np.int8)
    for bi in range(b):
        for h in range(HEADS):
            for q0 in range(0, sp, 128):
                boxes = np.zeros((4, 64, 8, 8), F32)
                for j in range(4):
                    rows = q[bi, h, q0 + 64 * (j >> 1):q0 + 64 * (j >> 1) + 64,
                             64 * (j & 1):64 * (j & 1) + 64]
                    for r in range(64):
                        boxes[j, r, np.arange(8) ^ (r & 7)] = \
                            rows[r].reshape(8, 8)
                tile = np.full(16384, 0x55, np.uint8)
                for i in range(128 * 16):
                    row, col = i >> 4, (i & 15) * 8
                    g = (col & 63) >> 3
                    v = boxes[(row >> 6) * 2 + (col >> 6), row & 63,
                              g ^ (row & 7)]
                    at = row * 128 + (((col >> 4) ^ (row & 7)) << 4) + \
                        (col & 15)
                    tile[at:at + 8] = _code(v, c["inv_q"]).view(np.uint8)
                q8[bi, h, q0:q0 + 128] = _read_k_major(tile, 1)
    return q8


def _main_model(q8, k8, v8t, s, c, *, pad_in_max=False, pad_in_l=False):
    """The main pass's order in numpy f32: (B, S, HEADS HD) bf16 values.
    pad_in_max / pad_in_l: the faults of the keys past S let into the first
    sweep's max / the second sweep's l."""
    b, _, sp, _ = q8.shape
    fac2 = F32(F32(c["fac"]) * LOG2E)
    cv = F32(c["cv"])
    keys = -(-s // 64) * 64
    live = np.arange(keys) < s
    pos = np.array([vt_pos(x) for x in range(sp)])
    out = np.zeros((b, s, HEADS, HD), F32)
    for bi in range(b):
        for h in range(HEADS):
            acc = (q8[bi, h].astype(np.float64)
                   @ k8[bi, h, :keys].astype(np.float64).T).astype(np.int64)
            mi = np.where(live | pad_in_max, acc, INT_MIN).max(-1)
            arg = ((acc - mi[:, None]).astype(np.float64)
                   * np.float64(fac2)).astype(F32)     # one rounding
            e = np.exp2(arg).astype(F32)
            if not pad_in_l:
                e[:, ~live] = 0.0
            lt = np.zeros((sp, 4), F32)          # a quad's per-thread sums
            for k0 in range(0, keys, 64):
                for j in range(8):
                    for ee in range(2):
                        lt = (lt + e[:, k0 + 8 * j + ee + 2 * np.arange(4)]
                              ).astype(F32)
            lsum = ((lt[:, 0] + lt[:, 1]).astype(F32)
                    + (lt[:, 2] + lt[:, 3]).astype(F32)).astype(F32)
            p8 = np.rint(e.astype(np.float64) * 127.0)   # one FFMA
            a_pos = np.zeros_like(p8)            # the A fragments' bytes
            a_pos[:, pos[:keys]] = p8
            pv = (a_pos.astype(np.float64)
                  @ v8t[bi, h][:, :keys].astype(np.float64).T).astype(F32)
            ap = ((F32(1) / lsum).astype(F32) + F32(1e-20)).astype(F32)
            o = (pv * (ap * cv).astype(F32)[:, None]).astype(F32)
            out[bi, :, h] = o[:s]
    return _bf16(out.reshape(b, s, HEADS * HD))


def _jax(qkv, scale):
    fn = J17.static_variant()(HEADS, HD, scale)
    return np.asarray(fn(jnp.asarray(qkv, jnp.bfloat16)), np.float32)


def _apart_rows(got, want):
    b, s, _ = got.shape
    bad = np.abs(got - want) > _bf16_step(np.maximum(np.abs(got),
                                                     np.abs(want)))
    return bad.reshape(b, s, HEADS, HD).any(-1)


def _holds(got, want, qkv, scale):
    """test_torch_port_probes.py's rule for kernel 17."""
    bad = _apart_rows(got, want)
    return (not (bad & ~_p8_ties(qkv, HEADS, HD, scale)).any()
            and bad.mean() <= 0.01)


# -------------------------------------------------- (a) the main pass


@pytest.mark.parametrize("b,s", [(1, 300), (2, 256), (1, 1000)])
def test_main_model_matches_pallas_interpret(b, s, interpret):
    scale = HD ** -0.5
    c = P17.static_scales(scale)
    qkv = _qkv(b, s, s)
    k8, v8t, _ = _prepass_model(qkv, c)
    got = _main_model(_q8_model(qkv, c), k8, v8t, s, c)
    assert np.isfinite(got).all()
    want = _jax(qkv, scale)
    assert _holds(got, want, qkv, scale)
    # the twin (JAX's order) under the same rule
    twin = P17.attention_qkv_int8_static(
        torch.from_numpy(qkv).to(torch.bfloat16), HEADS, HD, scale)
    assert _holds(twin.float().numpy(), want, qkv, scale)


# -------------------------------------------------- (b) the max


@pytest.mark.parametrize("b,s,negative", [(1, 300, False), (2, 256, False),
                                          (1, 1000, False), (1, 300, True)])
def test_integer_max_is_jax_f32_max(b, s, negative):
    scale = HD ** -0.5
    c = P17.static_scales(scale)
    qkv = _qkv(b, s, s, negative)
    q, k, _ = _heads(qkv)
    q8, k8 = _code(q, c["inv_q"]), _code(k, c["inv_k"])
    # JAX's `_one_head` scores and their row max
    sc = jax.lax.dot_general(
        jnp.asarray(q8), jnp.asarray(k8), (((3,), (3,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.int32).astype(jnp.float32) * (
            (3.0 * 3.0) / (127.0 * 127.0) * scale)
    want = np.asarray(jnp.max(sc, axis=-1))
    acc = np.einsum("bhqd,bhkd->bhqk", q8.astype(np.float64),
                    k8.astype(np.float64)).astype(np.int64)
    mi = acc.max(-1)
    got = (mi.astype(F32) * F32(c["fac"])).astype(F32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    d = np.concatenate([(acc - mi[..., None]).ravel(),
                        [0, -1, -2, -(2 ** 21), -2 * 127 * 127 * 128]])
    assert d.max() == 0 and d.min() > -(2 ** 22)
    np.testing.assert_array_equal(
        (2.0 ** 23 + d).astype(F32).view(np.int32), 0x4B000000 + 2 * d)
    if negative:
        assert (mi < 0).all()


# -------------------------------------------------- (c) the ragged-S traps


def test_keys_past_s_stay_out_of_the_max_and_the_sum(interpret):
    b, s = 1, 300
    scale = HD ** -0.5
    c = P17.static_scales(scale)
    qkv = _qkv(b, s, 7, negative=True)
    k8, v8t, _ = _prepass_model(qkv, c)
    q8 = _q8_model(qkv, c)
    want = _jax(qkv, scale)
    assert _holds(_main_model(q8, k8, v8t, s, c), want, qkv, scale)
    for fault in ("pad_in_max", "pad_in_l"):
        wrong = _main_model(q8, k8, v8t, s, c, **{fault: True})
        assert not _holds(wrong, want, qkv, scale), fault
        assert _apart_rows(wrong, want).mean() > 0.5, fault


# -------------------------------------------------- (d) the codes


@pytest.mark.parametrize("b,s", [(1, 300), (2, 256), (1, 1000), (1, 1)])
def test_code_models_equal_the_codes(b, s):
    c = P17.static_scales(1.0)
    qkv = _qkv(b, s, s + 1)
    k8, v8t, writes = _prepass_model(qkv, c)
    assert (writes == 1).all()               # every row once, none twice
    q8 = _q8_model(qkv, c)
    ref = P17.static_codes_reference(
        torch.from_numpy(qkv).to(torch.bfloat16), HEADS)
    for got, want in zip((q8, k8, v8t), ref):
        np.testing.assert_array_equal(got, want.numpy())
    sp = i8_pad(s)
    pos = np.array([vt_pos(x) for x in range(sp)])
    for i, (part, key) in enumerate(zip(_heads(qkv),
                                        ("inv_q", "inv_k", "inv_v"))):
        want = common.quant_codes(torch.from_numpy(part), c[key]).numpy()
        jx = np.asarray(jnp.clip(jnp.round(jnp.asarray(part) * (127.0 / 3.0)),
                                 -127, 127))
        np.testing.assert_array_equal(want, jx)
        codes = (q8, k8)[i][:, :, :s] if i < 2 else \
            v8t[..., pos[:s]].transpose(0, 1, 3, 2)
        np.testing.assert_array_equal(codes, want)
    assert not q8[:, :, s:].any() and not k8[:, :, s:].any()
    assert not v8t[..., pos[s:]].any()


# -------------------------------------------------- (e) the domain


@pytest.mark.parametrize("s", [1, 300, 1024, 131072])
def test_domain_is_the_parents(s):
    for b, heads in ((1, 1), (8, 16), (1, 2048), (P17.MAX_BATCH, 1)):
        if b * s > MAX_ROWS:
            continue
        qkv = torch.empty((b, s, 3 * heads * HD), dtype=torch.bfloat16,
                          device="meta")
        P17.check_static(qkv, heads, HD)         # the parent's check
        assert P17.static_fits(b, s, heads)
    # every qkv of at most 80 GB: its B H S_pad / 128 <= B H S fits an int
    for b in (1, 8, 64, P17.MAX_BATCH):
        heads = int(80e9 // (3 * HD * 2 * b * s))
        if heads and b * s <= MAX_ROWS:
            assert P17.static_fits(b, s, heads)
    # past MAX_SEQ and at head_dim 64 the parent raised, and still does
    with pytest.raises(ValueError):
        P17.check_static(torch.empty((1, MAX_SEQ + 1, 3 * HD),
                                     dtype=torch.bfloat16, device="meta"),
                         1, HD)


def test_domain_limits_match_the_source():
    src = (_build.CSRC / "attention_i8.cu").read_text()
    body = re.search(r"inline bool i8st_sm90_ok\(.*?\n}\n", src, re.S).group(0)
    assert f"batch <= {P17.MAX_BATCH}" in body
    assert "head_dim == 128" in body and "kI8Rows" in body
    assert re.search(r"constexpr int kMaxSeq = 1 << (\d+);",
                     (_build.CSRC / "common.cuh").read_text()).group(1) \
        == str(MAX_SEQ.bit_length() - 1)
    assert 127 * 127 * MAX_SEQ < 2 ** 31          # p8 . v8 in int32
    assert not P17.static_fits(P17.MAX_BATCH + 1, 1, 1)
    assert not P17.static_fits(1, 1024, MAX_ROWS // 8 + 1)
    # the mma.sync static instantiation and its scales are gone
    assert "I8AttnScales" not in src and "<128, true>" in src
    assert "attention_i8_kernel<128" not in src


# -------------------------------------------------- (f) the entry points


def test_c_entry_points_match_the_sources():
    src = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name, sig in _build.SIGNATURES.items():
        m = re.search(rf"TPUDF_API int {name}\(([^)]*)\)", src)
        params = [p.strip() for p in m.group(1).split(",") if p.strip()]
        got = "".join("p" if "*" in p else "f" if p.startswith("float")
                      else "i" for p in params)
        assert got == sig, (name, params)


def test_wrapper_launches_prepass_then_main(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "call", lambda name, *a: calls.append(
        (name, a)))
    b, s, heads = 2, 300, 3
    qkv = torch.empty((b, s, 3 * heads * HD), dtype=torch.bfloat16,
                      device="meta")
    c = P17.static_scales(HD ** -0.5)
    LAUNCHES.reset()
    out = P17.static_main(qkv, P17.static_prepass(qkv, heads), heads,
                          HD ** -0.5)
    assert out.shape == (b, s, heads * HD) and out.dtype == torch.bfloat16
    assert LAUNCHES.snapshot() == {P17.KERNEL_PREPASS: 1, P17.KERNEL: 1}
    (pre, a), (main, m) = calls
    assert (pre, main) == ("tpudf_attention_i8_static_prepass",
                           "tpudf_attention_i8_static")
    assert len(a) + 1 == len(_build.SIGNATURES[pre])
    assert len(m) + 1 == len(_build.SIGNATURES[main])
    sp = i8_pad(s)
    assert a[0] is qkv and m[0] is qkv
    assert a[1].shape == (b, heads, sp, HD) and a[2].shape == (b, heads, HD,
                                                               sp)
    assert a[1].dtype == a[2].dtype == torch.int8
    assert m[1] is a[1] and m[2] is a[2]         # the codes, passed on
    assert a[3:] == (b, s, heads, HD, c["inv_k"], c["inv_v"])
    assert m[4:] == (b, s, heads, HD, c["inv_q"], c["fac"], c["cv"])
