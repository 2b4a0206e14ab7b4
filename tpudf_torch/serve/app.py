"""Gradio front-end parity app on PyTorch (tpudf/serve/app.py; optional:
`main` needs gradio).

UI parity with the reference v5 detector (appv3.py:6846-7653):
  * HTML verdict header color-coded by label + probability gauge
  * metrics grid (expert probabilities, risk band, bayes/dirichlet, sora)
  * Maps tab: suspicious-region heatmap overlay, 3x3 forensic panel
    (appv3.py:2421-2464), jitter collage
  * Video tab: per-frame table [frame, p_fake, label] + frame gallery
  * Report tab: pretty JSON + download button
  * plain-language explanation (LLM client or heuristic fallback)

The rendering helpers are pure functions (copied from the JAX package);
the forensic maps, the panel and the collage compute on a torch device
(the engine's in `build_predict_fns`). Run:
    python -m tpudf_torch.serve.app --artifacts /path/siglip [--share] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from tpudf_torch.data.pipeline import resize
from tpudf_torch.data.video import sample_video
from tpudf_torch.ops.forensic_maps import (_norm01, forensic_map_battery,
                                           heatmap_overlay, jet_colors)
from tpudf_torch.ops.forensics import f32_math
from tpudf_torch.serve.explain import explain_report
from tpudf_torch.serve.report import predict_images, predict_video

_BAND_COLORS = {
    "REAL": "#22c55e", "LIKELY_REAL": "#4ade80", "UNCERTAIN": "#f59e0b",
    "LIKELY_FAKE": "#fb923c", "FAKE": "#ef4444", "TAMPERED": "#f59e0b",
    "INCONCLUSIVE": "#94a3b8",
}


def verdict_html(report: dict) -> str:
    """Color-coded verdict header (reference `verdict_html`)."""
    label = str(report.get("final_label", report.get("video_label", "?")))
    color = _BAND_COLORS.get(label.upper().replace(" ", "_"), "#94a3b8")
    prob = float(report.get("final_prob", report.get("video_prob", 0.5)))
    band = report.get("band_text", report.get("band", ""))
    verdict = report.get("verdict", "")
    sub = f"{band}" + (f" · {verdict}" if verdict else "")
    return (
        f'<div style="border-radius:16px;padding:18px 22px;'
        f'background:{color}22;border:2px solid {color};">'
        f'<div style="font-size:28px;font-weight:700;color:{color};">'
        f'{label}</div>'
        f'<div style="font-size:15px;opacity:.85;">P(fake) = {prob:.1%}'
        f'{" — " + sub if sub else ""}</div></div>')


def gauge_html(prob: float) -> str:
    """Probability gauge bar (reference `gauge_html`)."""
    prob = float(np.clip(prob, 0.0, 1.0))
    pct = prob * 100.0
    return (
        '<div style="padding:18px 6px;">'
        '<div style="font-size:12px;opacity:.7;margin-bottom:4px;">'
        'fake probability</div>'
        '<div style="background:#1f2937;border-radius:999px;height:18px;'
        'overflow:hidden;">'
        f'<div style="width:{pct:.1f}%;height:100%;border-radius:999px;'
        'background:linear-gradient(90deg,#22c55e,#f59e0b,#ef4444);">'
        '</div></div>'
        f'<div style="font-size:13px;margin-top:4px;">{prob:.1%}</div></div>')


def metrics_html(report: dict) -> str:
    """Key-signal grid (reference `metrics_html`)."""
    rows = []
    for key, label in (
            ("visual_prob", "SigLIP visual"), ("freq_prob", "Frequency"),
            ("fusion_prob", "Fusion"), ("coral_prob", "CORAL"),
            ("bayes_final_prob", "Bayes"), ("dirichlet_uncertainty",
                                            "Dirichlet unc."),
            ("forensic_score", "Forensics"), ("max_patch", "Max patch"),
            ("embedding_anomaly", "Embed anomaly"),
            ("sora_likelihood", "Sora likelihood"),
            ("temporal_consistency_score", "Temporal consistency")):
        v = report.get(key)
        if v is None:
            continue
        rows.append(
            f'<div style="background:#0f1115;border:1px solid #2a3442;'
            f'border-radius:12px;padding:8px 12px;">'
            f'<div style="font-size:11px;opacity:.6;">{label}</div>'
            f'<div style="font-size:18px;font-weight:600;">'
            f'{float(v):.3f}</div></div>')
    return ('<div style="display:grid;grid-template-columns:repeat('
            'auto-fill,minmax(130px,1fr));gap:8px;padding:6px 0;">'
            + "".join(rows) + "</div>")


def frames_timeline_html(frame_probs) -> str:
    """Per-frame probability strip for videos (reference `timeline_html`)."""
    if frame_probs is None or len(frame_probs) == 0:
        return ""
    cells = []
    for i, p in enumerate(frame_probs):
        p = float(p)
        col = "#ef4444" if p > 0.6 else ("#f59e0b" if p > 0.4 else "#22c55e")
        cells.append(
            f'<div title="frame {i}: {p:.2f}" style="flex:1;height:26px;'
            f'background:{col};opacity:{0.35 + 0.65 * p:.2f};"></div>')
    return ('<div style="display:flex;gap:2px;border-radius:8px;'
            'overflow:hidden;margin:6px 0;">' + "".join(cells) + "</div>")


def _to_device01(pixels_uint8, device):
    """uint8 (..., H, W, 3) → f32 [0, 1] on `device`."""
    return torch.as_tensor(np.ascontiguousarray(pixels_uint8)).to(
        device).float() / 255.0


def forensic_panel_image(pixels_uint8: np.ndarray, device="cuda"
                         ) -> np.ndarray:
    """3x3 forensic-map panel as one RGB image (appv3.py:2421-2464
    `forensic_panel`): original + 7 block anomaly maps + combined locator,
    jet-colored, on `device`; composited on the host in numpy."""
    x = _to_device01(pixels_uint8[None], device)
    with f32_math():
        if x.shape[1] != 256:
            x = resize(x, (1, 256, 256, 3), "bilinear")
        maps = forensic_map_battery(x)
        base = (resize(x[0], (256, 256, 3), "bilinear") * 255.0).cpu(
            ).numpy().astype(np.uint8)

        def colorize(m):
            m = _norm01(m)[0] if m.ndim == 3 else m
            m = resize(m, (256, 256), "bilinear").cpu().numpy()
            return jet_colors(np.clip(m, 0, 1))

        tiles = [("original", base)]
        for key in ("prnu_strength", "prnu_fft", "cfa_anomaly",
                    "jpeg_residual", "patch_variance", "multiscale_fft",
                    "perlin", "combined"):
            if key in maps:
                tiles.append((key, colorize(maps[key])))
    while len(tiles) < 9:
        tiles.append(("", np.zeros((256, 256, 3), np.uint8)))

    pad, title_h = 4, 18
    cell = 256
    canvas = np.full((3 * (cell + title_h + pad) + pad,
                      3 * (cell + pad) + pad, 3), 16, np.uint8)
    for i, (name, img) in enumerate(tiles[:9]):
        r, c = divmod(i, 3)
        y = pad + r * (cell + title_h + pad) + title_h
        xx = pad + c * (cell + pad)
        canvas[y:y + cell, xx:xx + cell] = img
    return canvas


def jitter_collage(pixels_uint8: np.ndarray, n=4, seed=0, device="cuda"
                   ) -> np.ndarray:
    """Side-by-side jittered crops (appv3.py jitter collage): quick visual
    stability check of the detector's input neighborhood. The crops are
    drawn on the host (np.random.default_rng(seed)), resized back on
    `device` (bilinear, `resize`) and truncated to uint8."""
    rng = np.random.default_rng(seed)
    h, w = pixels_uint8.shape[:2]
    out = []
    for _ in range(n):
        dy, dx = rng.integers(0, max(1, h // 16), 2)
        crop = pixels_uint8[dy:h - (h // 16 - dy) or h,
                            dx:w - (w // 16 - dx) or w]
        with f32_math():
            big = resize(torch.as_tensor(np.ascontiguousarray(crop)).to(
                device).float(), (h, w, 3), "bilinear")
        out.append(big.cpu().numpy().astype(np.uint8))
    return np.concatenate(out, axis=1)


def report_json_file(report: dict) -> str:
    """Write the JSON report to a temp file for the download button.
    Old report files from this process are pruned (gradio's DownloadButton
    never deletes its source, so a long-running demo would otherwise
    accumulate one file per Analyze click)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="tpudf_report_")
    with os.fdopen(fd, "w") as f:
        json.dump(report, f, indent=2, default=float)
    old = getattr(report_json_file, "_last", None)
    if old:
        try:
            os.unlink(old)
        except OSError:
            pass
    report_json_file._last = path
    return path


def build_predict_fns(engine):
    """(predict_image, predict_clip) closures over a DetectEngine; the
    maps, panel and collage compute on the engine's device.

    predict_image(pil) -> (verdict_html, gauge_html, metrics_html,
        explanation, heatmap_overlay, forensic_panel, jitter, json_str,
        json_path)
    predict_clip(path) -> (verdict_html, gauge_html, metrics_html,
        timeline_html, explanation, key_frame, frame_rows, gallery,
        json_str, json_path)
    """
    device = engine.device

    def predict_image(pil_img):
        from PIL import Image
        size = engine.cfg.image_size
        img = pil_img.convert("RGB").resize((size, size), Image.BICUBIC)
        px = np.array(img, np.uint8)          # writable: torch shares it
        report = predict_images(engine, px[None])[0]
        x = _to_device01(px[None], device)
        with f32_math():
            if size != 256:
                x = resize(x, (1, 256, 256, 3), "bilinear")
            maps = forensic_map_battery(x)
        overlay = heatmap_overlay(px, maps["combined"][0])
        panel = forensic_panel_image(px, device)
        jit_img = jitter_collage(px, device=device)
        expl = explain_report(report)
        js = json.dumps(report, indent=2, default=float)
        return (verdict_html(report), gauge_html(report["final_prob"]),
                metrics_html(report), expl["summary"], overlay, panel,
                jit_img, js, report_json_file(report))

    def predict_clip(video_path):
        frames, _ = sample_video(video_path, size=engine.cfg.image_size)
        if frames is None:
            empty = "<div>DECODE FAILED</div>"
            return (empty, gauge_html(0.5), "", "", "", None, [], [],
                    "{}", report_json_file({"error": "decode failed"}))
        rep = predict_video(engine, frames)
        expl = explain_report(rep["chosen_frame_report"])
        probs = rep.get("frame_probs", [])
        labels = rep.get("frame_labels", [])
        rows = [[int(i), round(float(p), 4),
                 labels[i] if i < len(labels) else ""]
                for i, p in enumerate(probs)]
        gallery = [np.asarray(f) for f in frames]
        chosen = frames[rep["chosen_frame"]]
        js = json.dumps(rep, indent=2, default=float)
        return (verdict_html(rep), gauge_html(rep["video_prob"]),
                metrics_html(rep.get("chosen_frame_report", rep)),
                frames_timeline_html(probs), expl["summary"], chosen, rows,
                gallery, js, report_json_file(rep))

    return predict_image, predict_clip


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifacts", default=None)
    p.add_argument("--model_size", default="base-256")
    p.add_argument("--backbone_ckpt", default=None)
    p.add_argument("--head_ckpt", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--share", action="store_true")
    # deployed speed modes
    p.add_argument("--int8", action="store_true",
                   help="statically-quantized W8A8 tower")
    p.add_argument("--tome_r", type=int, default=None, const=-1, nargs="?",
                   help="ToMe token merging (bare flag = certified "
                        "DEPLOYED_TOME_R)")
    p.add_argument("--patch_tome", action="store_true",
                   help="deeper ToMe on the 32 patch-grid views of the "
                        "full analysis")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    args = p.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed in this environment; "
                         "use `python -m tpudf_torch.cli.infer` for batch "
                         "inference instead")

    from tpudf_torch.cli.infer import build_engine
    engine = build_engine(args)
    predict_image, predict_clip = build_predict_fns(engine)

    with gr.Blocks(title="tpudf deepfake detector") as demo:
        gr.Markdown("# tpudf — deepfake detection")
        with gr.Tab("Image"):
            with gr.Row():
                with gr.Column(scale=1):
                    inp = gr.Image(type="pil")
                    btn = gr.Button("Analyze", variant="primary")
                with gr.Column(scale=2):
                    with gr.Row():
                        vh = gr.HTML()
                        gh = gr.HTML()
                    mh = gr.HTML()
                    expl = gr.Markdown()
                    with gr.Tabs():
                        with gr.Tab("Maps"):
                            with gr.Row():
                                overlay = gr.Image(
                                    label="Suspicious regions")
                                panel = gr.Image(label="Forensic panel")
                                jit_img = gr.Image(label="Jitter")
                        with gr.Tab("Report"):
                            js = gr.Code(label="JSON report",
                                         language="json")
                            dl = gr.DownloadButton("Download JSON")
            btn.click(predict_image, inp,
                      [vh, gh, mh, expl, overlay, panel, jit_img, js, dl])
        with gr.Tab("Video"):
            with gr.Row():
                with gr.Column(scale=1):
                    vin = gr.Video()
                    vbtn = gr.Button("Analyze video", variant="primary")
                with gr.Column(scale=2):
                    with gr.Row():
                        vvh = gr.HTML()
                        vgh = gr.HTML()
                    vmh = gr.HTML()
                    vtl = gr.HTML()
                    vexpl = gr.Markdown()
                    with gr.Tabs():
                        with gr.Tab("Frames"):
                            vframe = gr.Image(label="Key frame")
                            vtable = gr.Dataframe(
                                headers=["frame", "p_fake", "label"],
                                interactive=False)
                            vgal = gr.Gallery(columns=4)
                        with gr.Tab("Report"):
                            vjs = gr.Code(label="JSON report",
                                          language="json")
                            vdl = gr.DownloadButton("Download JSON")
            vbtn.click(predict_clip, vin,
                       [vvh, vgh, vmh, vtl, vexpl, vframe, vtable, vgal,
                        vjs, vdl])
    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
