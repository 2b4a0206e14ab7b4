"""Human-readable explanation of a detection report.

A copy of tpudf/serve/explain.py (no framework), kept here so that this
package imports nothing of `tpudf`.

Re-implements the reference's LLM-explanation layer (appv3.py:243-506):
an OpenAI-compatible chat client (env-gated — zero-egress environments get
no network) and the deterministic heuristic fallback (:371-432) that turns
the signal dict into a summary/label/signals/confidence JSON.
"""

from __future__ import annotations

import json
import os


def _signal_notes(report: dict) -> list[str]:
    notes = []

    def g(k, d=0.0):
        v = report.get(k)
        return float(v) if v is not None else d

    if g("visual_head") > 0.7:
        notes.append("the visual (SigLIP) expert scores this strongly fake")
    elif g("visual_head") < 0.3:
        notes.append("the visual (SigLIP) expert scores this strongly real")
    if g("freq_head") > 0.7:
        notes.append("frequency-domain statistics look synthetic")
    if g("forensic_perlin", g("forensic_score")) > 0.6:
        notes.append("diffusion-style smoothness detected")
    if g("cfa_fake_score") > 0.6:
        notes.append("camera CFA pattern appears broken")
    elif g("cfa_fake_score") < 0.2:
        notes.append("camera CFA pattern is intact")
    if g("forensic_grain") > 0.7:
        notes.append("natural photographic grain present")
    if g("jpeg_q_mismatch_score") > 0.7:
        notes.append("heavy or inconsistent JPEG recompression")
    if g("max_patch") > 0.85 and g("patch_mean") < 0.5:
        notes.append("one localized region scores much higher than the rest"
                     " (possible local edit)")
    if g("dirichlet_uncertainty") > 0.4:
        notes.append("evidence sources disagree; confidence is reduced")
    return notes


def heuristic_explanation(report: dict) -> dict:
    """Deterministic explanation (appv3.py:371-432 fallback semantics)."""
    label = report.get("final_label", "INCONCLUSIVE")
    p = float(report.get("final_prob", 0.5))
    certainty = float(report.get("bayesian_fusion_certainty", 0.5))
    notes = _signal_notes(report)
    if label == "FAKE":
        summary = (f"This media is likely synthetic or manipulated "
                   f"(fake probability {p:.0%}).")
    elif label == "REAL":
        summary = (f"This media is likely an unmodified photograph "
                   f"(fake probability {p:.0%}).")
    elif label == "TAMPERED":
        summary = (f"This media appears to be a real photo with local "
                   f"edits (fake probability {p:.0%}).")
    else:
        summary = ("The evidence is inconclusive; experts disagree "
                   f"(fake probability {p:.0%}).")
    if notes:
        summary += " Key signals: " + "; ".join(notes[:4]) + "."
    conf = "high" if certainty > 0.75 else (
        "medium" if certainty > 0.5 else "low")
    return {"summary": summary, "label": label, "signals": notes,
            "confidence": conf, "source": "heuristic"}


def explain_report(report: dict, use_llm: bool | None = None) -> dict:
    """LLM explanation when configured (LLM_API_BASE/LLM_API_KEY env,
    OpenAI-compatible chat endpoint — appv3.py:243-370), else heuristic."""
    if use_llm is None:
        use_llm = bool(os.getenv("LLM_API_KEY"))
    if not use_llm:
        return heuristic_explanation(report)
    try:
        import urllib.request
        base = os.getenv("LLM_API_BASE",
                         "https://router.huggingface.co/v1")
        model = os.getenv("LLM_MODEL",
                          "meta-llama/Llama-3.1-70B-Instruct")
        slim = {k: v for k, v in report.items()
                if isinstance(v, (int, float, str)) and
                not k.startswith("forensic_")}
        body = json.dumps({
            "model": model,
            "messages": [
                {"role": "system",
                 "content": "You are a forensic media analyst. Given "
                            "detector signals, reply with JSON: {summary, "
                            "label, signals, confidence}."},
                {"role": "user", "content": json.dumps(slim)},
            ],
            "response_format": {"type": "json_object"},
        }).encode()
        req = urllib.request.Request(
            base.rstrip("/") + "/chat/completions", data=body,
            headers={"Authorization": f"Bearer {os.environ['LLM_API_KEY']}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.load(resp)
        parsed = json.loads(out["choices"][0]["message"]["content"])
        parsed["source"] = "llm"
        return parsed
    except Exception:
        return heuristic_explanation(report)
