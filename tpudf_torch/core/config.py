"""Environment-variable config system with clipping/sanity repair.

A copy of tpudf/core/config.py (no framework), kept here so that this
package imports nothing of `tpudf`.

Mirrors the reference's ~35 env knobs (appv3.py:123-230) as a typed,
validated config object instead of module-level globals. Every value is
env-overridable with the same names; out-of-range values are clipped and
reported rather than crashing (appv3.py:211-230 behaviour).
"""

from __future__ import annotations

import dataclasses
import os


def _env_float(name, default, lo=None, hi=None, repairs=None):
    raw = os.getenv(name)
    try:
        v = float(raw) if raw is not None else float(default)
    except (TypeError, ValueError):
        v = float(default)
    if lo is not None and v < lo:
        if repairs is not None:
            repairs.append(f"{name}={v} clipped to {lo}")
        v = lo
    if hi is not None and v > hi:
        if repairs is not None:
            repairs.append(f"{name}={v} clipped to {hi}")
        v = hi
    return v


def _env_int(name, default, lo=None, hi=None, repairs=None):
    return int(_env_float(name, default, lo, hi, repairs))


def _env_bool(name, default):
    raw = os.getenv(name)
    if raw is None:
        return bool(default)
    return raw.strip() in {"1", "true", "True"}


@dataclasses.dataclass(frozen=True)
class AppConfig:
    # decision thresholds (appv3.py:142-160)
    final_real_thresh: float = 0.45
    final_fake_thresh: float = 0.75
    disable_tampered: bool = False
    disable_inconclusive: bool = False
    # feature toggles (appv3.py:123-140)
    use_clahe: bool = False
    use_fusion: bool = True
    # video sampling (appv3.py:134-139)
    video_stride: int = 5
    video_max_samples: int = 12
    video_cut_thresh: float = 0.45
    video_workers: int = 2
    # freq expert
    freq_temp: float = 1.25
    # image guards (appv3.py:572-573)
    min_side: int = 64
    max_side: int = 2048
    # aggregation
    video_strictness: str = "balanced"
    video_agg_mode: str = "topk_mean"
    video_topk_frac: float = 0.30
    video_min_agree: int = 2

    repairs: tuple = ()

    @classmethod
    def from_env(cls) -> "AppConfig":
        rep: list[str] = []
        cfg = cls(
            final_real_thresh=_env_float("FINAL_REAL_THRESH", 0.45, 0.05,
                                         0.95, rep),
            final_fake_thresh=_env_float("FINAL_FAKE_THRESH", 0.75, 0.05,
                                         0.99, rep),
            disable_tampered=_env_bool("DISABLE_TAMPERED", False),
            disable_inconclusive=_env_bool("DISABLE_INCONCLUSIVE", False),
            use_clahe=_env_bool("DETECT_USE_CLAHE", False),
            use_fusion=_env_bool("DETECT_USE_FUSION", True),
            video_stride=_env_int("DETECT_VIDEO_STRIDE", 5, 1, 100, rep),
            video_max_samples=_env_int("DETECT_VIDEO_MAX_SAMPLES", 12, 1,
                                       64, rep),
            video_cut_thresh=_env_float("DETECT_VIDEO_CUT_THRESH", 0.45,
                                        0.01, 1.0, rep),
            video_workers=_env_int("DETECT_VIDEO_WORKERS", 2, 1, 32, rep),
            freq_temp=_env_float("FREQ_TEMP", 1.25, 0.1, 10.0, rep),
            min_side=_env_int("DETECT_MIN_SIDE", 64, 8, 4096, rep),
            max_side=_env_int("DETECT_MAX_SIDE", 2048, 64, 8192, rep),
            video_strictness=os.getenv("VIDEO_STRICTNESS", "balanced"),
            video_agg_mode=os.getenv("VIDEO_AGG_MODE", "topk_mean"),
            video_topk_frac=_env_float("VIDEO_TOPK_FRAC", 0.30, 0.05, 1.0,
                                       rep),
            video_min_agree=_env_int("VIDEO_MIN_AGREE", 2, 1, 16, rep),
            repairs=tuple(rep),
        )
        # cross-field sanity (appv3.py:211-230): thresholds must be ordered
        if cfg.final_real_thresh >= cfg.final_fake_thresh:
            object.__setattr__(cfg, "final_real_thresh",
                               min(0.45, cfg.final_fake_thresh - 0.05))
            object.__setattr__(
                cfg, "repairs",
                cfg.repairs + ("FINAL_REAL_THRESH >= FINAL_FAKE_THRESH; "
                               "reset to ordered defaults",))
        return cfg

    def decision_config(self):
        from tpudf_torch.fuse.decision import DecisionConfig
        return DecisionConfig(
            final_fake_thresh=self.final_fake_thresh,
            final_real_thresh=self.final_real_thresh,
            disable_tampered=self.disable_tampered,
            disable_inconclusive=self.disable_inconclusive,
        )
