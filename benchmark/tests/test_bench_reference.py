"""The plain references held to the port's plain twins on the CPU at the
test size: in f32 (the port's F32 policy, its twins in place of the
kernels) the two compute the same functions, so they agree to rounding;
in the port's own precision every tiny cell reads inside its limits."""

import json

import pytest
import torch

from benchmark.harness import inputs, weights
from benchmark.paths.detect import port_config
from benchmark.reference import siglip as ref_siglip
from benchmark.reference.common import SOUND
from benchmark.reference.detect import DetectReference
from conftest import DATA, run_cpu

CFG = json.loads((DATA / "tiny.json").read_text())
DEV = torch.device("cpu")


def params(seed=7):
    return weights.make(weights.detect_spec(CFG),
                        weights.generator(seed, weights.WEIGHTS, DEV), DEV)


def images(n, seed=7):
    return inputs.images(weights.generator(seed, weights.INPUTS, DEV), n,
                         CFG["image_size"], DEV)


def test_bench_float_tower_matches_the_port_in_f32():
    from tpudf_torch.core.precision import F32_POLICY
    from tpudf_torch.models.siglip import siglip_forward
    from tpudf_torch.ops.routes import TWINS
    p = params()
    x = images(3).float() / 127.5 - 1.0
    got = siglip_forward(p["backbone"], x, port_config(CFG), F32_POLICY,
                         kernels=TWINS)["pooled"]
    tok, _ = ref_siglip.float_tower(p["backbone"], x, CFG, SOUND)
    want = ref_siglip.map_head(tok, p["backbone"]["head"], CFG, SOUND)
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5)


def test_bench_calibration_matches_the_port_in_f32():
    from tpudf_torch.core.precision import F32_POLICY
    from tpudf_torch.ops.quant import calibrate_siglip_act_scales
    p = params()
    x = images(4).float() / 127.5 - 1.0
    got = calibrate_siglip_act_scales(p["backbone"], port_config(CFG), x,
                                      F32_POLICY)
    want = ref_siglip.calibrate(p["backbone"], x, CFG)
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=1e-5), k


def test_bench_detect_core_matches_the_port_in_f32():
    """The W8A8 tower with ToMe, the heads, the frequency expert, the
    fusion and CORAL: the port's detect_core at f32 on the twins, with
    its own calibration and quantisation, against the reference."""
    from tpudf_torch.calib.coral import CoralCutpoints
    from tpudf_torch.convert import add_kernel_layout
    from tpudf_torch.core.precision import F32_POLICY
    from tpudf_torch.entry import detect_core
    from tpudf_torch.ops.quant import (calibrate_siglip_act_scales,
                                       quantize_siglip_static)
    from tpudf_torch.ops.routes import TWINS
    p = params()
    calib, px = images(4, seed=8), images(6)
    cfg = port_config(CFG)
    scales = calibrate_siglip_act_scales(
        p["backbone"], cfg, calib.float() / 127.5 - 1.0, F32_POLICY)
    q = add_kernel_layout(dict(p, backbone=quantize_siglip_static(
        p["backbone"], scales, cfg)))
    got = detect_core(q, px.float() / 255.0, cfg, CoralCutpoints.default(),
                      F32_POLICY, kernels=TWINS)
    want = DetectReference(p, calib, CFG, SOUND)(px, 64)
    for k in want:
        assert torch.allclose(got[k].float(), want[k], atol=1e-3), k


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.full", "tiny.mtl"])
@pytest.mark.parametrize("seed", [11, 12])
def test_bench_port_inside_limits(bench_root, cell, seed):
    out = run_cpu(bench_root, cell, seed=seed)
    assert out["correct"], out["checks"]
