"""The operation counts from shapes: ToMe's token schedule, the 53
views, and the roofline and MFU arithmetic."""

import json

import pytest

from benchmark.harness import counts, peaks
from benchmark.reference import siglip as ref_siglip
from conftest import BENCH


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,tokens", [
    ("base-256", [256, 160, 80, 40] + [32] * 8),
    ("large-384", [576, 480, 384, 288, 192, 96] + [72] * 18)])
def test_bench_tome_tokens(name, tokens):
    sz = counts.shape(config(name))
    assert counts.tome_tokens(sz["N"], sz["L"]) == tokens
    sched = ref_siglip.tome_schedule(sz["N"], sz["L"])
    assert [sz["N"] - sum(sched[:i]) for i in range(sz["L"])] == tokens


@pytest.mark.parametrize("name", ["base-256", "large-384"])
def test_bench_tome_schedule_is_the_ports(name):
    from tpudf_torch.ops.tome import deployed_floor, merge_schedule
    sz = counts.shape(config(name))
    assert tuple(ref_siglip.tome_schedule(sz["N"], sz["L"])) == \
        merge_schedule(sz["N"], sz["L"], 96, deployed_floor(sz["N"]))


def test_bench_layer_products_base():
    # 2 · (3W² + W² + 2WM) a token: the 14.16 MFLOP of a base-256 block
    assert counts.mm_ops(counts.layer_products(1, 768, 3072)) == 14155776
    assert counts.attention_ops(32, 768) == 4 * 32 * 32 * 768


def test_bench_detect_ops_sum():
    c = config("base-256")
    sz = counts.shape(c)
    toks = counts.tome_tokens(sz["N"], sz["L"])
    linear = sum(counts.mm_ops(counts.layer_products(t, 768, 3072))
                 for t in toks)
    assert sum(toks) == 792
    assert linear == 792 * 14155776
    total = counts.detect_ops_per_image(c)
    extra = total - linear
    # patch embedding, attention, merges and heads: a few % on top
    assert 0 < extra < 0.1 * total


def test_bench_request_counts_53_views():
    c = config("base-256")
    one = counts.request_ops(c, 1)
    sz = counts.shape(c)
    tower = counts.tower_ops(sz, [sz["N"]] * sz["L"], False)
    head = counts.binary_head_ops(sz["W"])
    assert one == 53 * (tower + head) + 34 * counts.freq_mlp_ops()
    assert counts.request_ops(c, 8) == 8 * one
    ops, n_bytes = counts.request_bf16gemm_work(c, 8)
    rows = 424 * 256
    assert ops["bf16"] == 12 * counts.mm_ops(
        counts.layer_products(rows, 768, 3072))
    assert n_bytes > 2 * rows * 768 * 12


def test_bench_i8gemm_work_is_ops_bound_at_b1024():
    ops, n_bytes = counts.detect_i8gemm_work(config("base-256"), 1024)
    t = peaks.bound_s(ops, n_bytes)
    assert t == pytest.approx(ops["int8"] / peaks.PEAK["int8"])
    assert n_bytes / peaks.HBM_BYTES_PER_S < t


def test_bench_bound_and_share():
    assert peaks.bound_s({"bf16": 989e12}, 0) == pytest.approx(1.0)
    assert peaks.bound_s({}, 3.35e12) == pytest.approx(1.0)
    assert peaks.share(0.5, 2.0) == pytest.approx(25.0)
    assert peaks.share(1.0, 0.0) is None


def test_bench_mtl_ops_count_the_frozen_prefix_once():
    c = config("large-384")
    all_frozen = counts.mtl_ops_per_image(c, 384, 24, (2, 6, 10, -1), 256)
    three = counts.mtl_ops_per_image(c, 384, 21, (2, 6, 10, -1), 256)
    sz = counts.shape(c)
    layer = (counts.mm_ops(counts.layer_products(sz["N"], 1024, 4096))
             + counts.attention_ops(sz["N"], 1024))
    # three layers trained: their backward (2x forward), less the input
    # gradient of the first one's qkv product, which no leaf needs
    assert three - all_frozen == 6 * layer - 2 * sz["N"] * 1024 * 3 * 1024
