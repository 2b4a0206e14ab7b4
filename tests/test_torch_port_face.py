"""The report's face escalation, kernel launches, service and explanation
on the CPU.

The synthetic images hold no face, so `detect_faces` is monkeypatched in
both packages to return the same boxes (a large one that escalates, a
small one that only gets the retouch score, none), on 256 px images. Both
engines share one seeded numpy tree of a 256 px test tower (width 64, 2
layers, patch 32) under the f32 policy.
  _dispatch_face  the retouch scores within atol 2e-4 + rtol 2e-3 (the
       goldens' rule), the escalated crop's p_fake_raw within 2e-3 (the
       f32 engine's rule, tests/test_torch_port_engine.py); the same
       indices; the port's full report carries them
  no kernel on the CPU   a report on a CPU engine (full, with the
       escalation, and fast) launches no kernel
  DetectService   its reports are predict_images' (1e-5, labels equal),
       its warm-up and stats; the heuristic explanation equals JAX's on
       the port's reports
"""


import jax
import numpy as np
import pytest
import torch

from tests.test_report_golden import _images
from tests.test_torch_port_float import numpy_params
from tests.test_torch_port_float import one_torch_thread  # noqa: F401
from tpudf.calib.coral import CoralCutpoints as JCuts
from tpudf.core.precision import F32_POLICY as J_F32
from tpudf.models.freq_mlp import init_freq_mlp as j_init_freq
from tpudf.models.fusion import init_fusion_linear as j_init_fusion
from tpudf.models.heads import init_binary_head as j_init_head
from tpudf.models.siglip import SigLIPConfig as JConfig
from tpudf.models.siglip import init_siglip as j_init_siglip
from tpudf.serve import explain as J_explain
from tpudf.serve import report as J_report
from tpudf.serve.engine import DetectEngine as JEngine
from tpudf_torch.convert import params_from_numpy
from tpudf_torch.core.backend import LAUNCHES
from tpudf_torch.core.precision import F32_POLICY
from tpudf_torch.models.siglip import SigLIPConfig
from tpudf_torch.serve import explain as T_explain
from tpudf_torch.serve import report as T_report
from tpudf_torch.serve.engine import DetectEngine
from tpudf_torch.serve.service import DetectService

GOLDEN = dict(atol=2e-4, rtol=2e-3)
CFG = (64, 2, 2, 128, 256, 32)
# per image: a box that escalates (its crop 225 px, 77 % of the frame),
# one that does not (75 px), none
BOXES = ([(40, 50, 150, 150)], [(100, 90, 50, 50)], [])


@pytest.fixture(scope="module")
def engines():
    jcfg = JConfig(*CFG)
    k = jax.random.key(0)
    tree = numpy_params(lambda: {
        "backbone": j_init_siglip(k, jcfg), "head": j_init_head(k, 64),
        "freq": j_init_freq(k), "fusion": j_init_fusion(k)}, 3)
    jeng = JEngine(cfg=jcfg, cuts=JCuts.default(), policy=J_F32,
                   **jax.tree.map(jax.numpy.asarray, tree))
    eng = DetectEngine(cfg=SigLIPConfig(*CFG), policy=F32_POLICY,
                       **params_from_numpy({**tree, "cuts": jeng.cuts},
                                           "cpu"))
    return jeng, eng


def _pixels():
    return np.concatenate([_images(2, 256), _images(1, 256)[:, ::-1]])


@pytest.fixture
def faces(monkeypatch):
    """Both packages' detect_faces return BOXES in call order, one image at
    a time; `faces()` restarts the order."""
    state = {}

    def restart():
        state["calls"] = iter(BOXES * 4)
    restart()
    stub = lambda img, min_size=48: list(next(state["calls"]))
    monkeypatch.setattr("tpudf.serve.face.detect_faces", stub)
    monkeypatch.setattr("tpudf_torch.serve.face.detect_faces", stub)
    return restart


def test_face_escalation_matches_jax(engines, faces):
    jeng, eng = engines
    px = _pixels()
    want = jax.device_get(J_report._dispatch_face(jeng, px))
    faces()
    got = T_report._dispatch_face(eng, px)
    assert got["det_idx"] == want["det_idx"] == [0, 1]
    assert got["esc_idx"] == want["esc_idx"] == [0]
    np.testing.assert_allclose(got["retouch"].numpy(), want["retouch"],
                               **GOLDEN)
    np.testing.assert_allclose(got["esc_p"].numpy(), want["esc_p"],
                               atol=2e-3, rtol=0)
    p_fake, retouch = T_report._face_signals_from_fetched(
        {k: v.numpy() if torch.is_tensor(v) else v for k, v in got.items()},
        3)
    faces()
    reports = T_report.predict_images(eng, px)
    for i, r in enumerate(reports):
        assert r["face_p_fake"] == p_fake[i]
        assert r["face_retouch_score"] == retouch[i]
    assert p_fake[1] is None and retouch[2] is None
    assert p_fake[0] is not None and retouch[1] is not None


def test_report_on_cpu_launches_no_kernel(engines, faces):
    _, eng = engines
    px = _pixels()
    LAUNCHES.reset()
    T_report.predict_images(eng, px)
    T_report.predict_images(eng, px, fast=True)
    assert LAUNCHES.snapshot() == {}


def _close_reports(got, want):
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= 1e-5 or (w != w and got[k] != got[k])
        elif k not in ("verdict", "risk_probs", "patch_probs"):
            assert got[k] == w, k
    assert got["verdict"]["label"] == want["verdict"]["label"]


def test_service_and_explanation(engines, monkeypatch):
    monkeypatch.delenv("LLM_API_KEY", raising=False)
    _, eng = engines
    px = _pixels()
    svc = DetectService(eng, max_batch=2, max_wait_ms=50.0)
    try:
        svc.warmup(max_bucket=1)
        got = [svc.predict(px[i], timeout=120.0) for i in range(2)]
        fast = svc.predict(px[0], fast=True, timeout=120.0)
        stats = svc.snapshot_stats()
    finally:
        svc.close()
    want = T_report.predict_images(eng, px[:2])
    for g, w in zip(got, want):
        _close_reports(g, w)
    _close_reports(fast, T_report.predict_images(eng, px[:1], fast=True)[0])
    assert stats["requests"] == 3 and stats["images"] == 3
    assert stats["p99_latency_s"] >= stats["p50_latency_s"] > 0
    for r in got + [fast]:
        e = T_explain.explain_report(r)
        assert e == J_explain.heuristic_explanation(r)
        assert e["source"] == "heuristic"
