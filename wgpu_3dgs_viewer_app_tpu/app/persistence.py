"""App-state persistence — the eframe-storage equivalent.

Parity with reference: eframe persists `State { compressions }` (+ dock
layout) via serde; the loaded scene is `#[serde(skip)]`
(`src/app.rs:16-17,311-314,331-340`). Here the same subset — compression
settings and UI-ish preferences, never the loaded models — serializes to a
JSON file (default `~/.config/gs3d/state.json`).
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Optional

from ..core.transform import GaussianDisplayMode, GaussianShDegree
from ..data.compression import Compressions, Cov3dCompression, ShCompression

DEFAULT_PATH = Path(
    os.environ.get("GS3D_STATE", "~/.config/gs3d/state.json")
).expanduser()


def save_state(session, path: Optional[Path] = None) -> Path:
    path = Path(path or DEFAULT_PATH)
    path.parent.mkdir(parents=True, exist_ok=True)
    gt = session.gaussian_transform
    data = {
        "compressions": {
            "sh": session.compressions.sh.value,
            "cov3d": session.compressions.cov3d.value,
        },
        "gaussian_transform": {
            "size": gt.size,
            "display_mode": gt.display_mode.name.lower(),
            "sh_deg": gt.sh_deg.degree,
            "no_sh0": gt.no_sh0,
        },
        "camera": {
            "speed": session.camera.speed,
            "sensitivity": session.camera.sensitivity,
            "fov_deg": math.degrees(session.camera.control.vertical_fov),
        },
        "theme": getattr(session, "theme", "dark"),
    }
    path.write_text(json.dumps(data, indent=2))
    return path


def load_compressions(path: Optional[Path] = None) -> Compressions:
    """Load persisted compression settings (defaults when absent)."""
    path = Path(path or DEFAULT_PATH)
    if not path.exists():
        return Compressions()
    try:
        data = json.loads(path.read_text())
        c = data.get("compressions", {})
        return Compressions(
            sh=ShCompression(c.get("sh", "norm8")),
            cov3d=Cov3dCompression(c.get("cov3d", "half")),
        )
    except (ValueError, KeyError):
        return Compressions()


def restore_state(session, path: Optional[Path] = None) -> bool:
    """Apply persisted preferences to a session; returns True if loaded."""
    path = Path(path or DEFAULT_PATH)
    if not path.exists():
        return False
    try:
        data = json.loads(path.read_text())
    except ValueError:
        return False
    gt = data.get("gaussian_transform", {})
    g = session.gaussian_transform
    g.size = float(gt.get("size", g.size))
    if "display_mode" in gt:
        g.display_mode = GaussianDisplayMode[gt["display_mode"].upper()]
    if "sh_deg" in gt:
        g.sh_deg = GaussianShDegree(int(gt["sh_deg"]))
    g.no_sh0 = bool(gt.get("no_sh0", g.no_sh0))
    cam = data.get("camera", {})
    session.camera.speed = float(cam.get("speed", session.camera.speed))
    session.camera.sensitivity = float(cam.get("sensitivity", session.camera.sensitivity))
    if "fov_deg" in cam:
        session.camera.control.vertical_fov = math.radians(float(cam["fov_deg"]))
    if data.get("theme") in ("dark", "light"):
        session.theme = data["theme"]
    return True
