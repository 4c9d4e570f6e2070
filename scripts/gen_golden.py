"""Golden-image fixture: the standing fidelity artifact for CI.

Renders the first 20k records of the COMMITTED trained-like PLY fixture
(tests/fixtures/trained_like_100k.ply — Inria-format binary, trained-model
statistics, row-shuffled so a prefix is a representative crop; see
scripts/gen_fixture_ply.py) from a fixed camera through the real CLI path
(PLY on disk -> read_ply -> Viewer -> PNG) and compares/updates the
committed golden PNG. Rendering from a committed FILE (not re-synthesized
arrays) means edits to data/synthetic.py can never silently move the
fidelity anchor.

The committed artifact pins the whole image-formation chain — compression
round-trip, preprocess, tile binning, sort, OIT composite — so any drift
(kernel rewrite, constant change, enumeration-order bug) fails CI instead
of passing silently. This is the repo-local anchor for the north star
"pixel-comparable rendering" (BASELINE.json render contract; reference
draw order `src/tab/scene.rs:2306-2313`).

Usage:
  python scripts/gen_golden.py --update   # regenerate tests/golden/*.png
  python scripts/gen_golden.py            # render to /tmp and diff
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "golden_256.png")

# Committed scene fixture (scripts/gen_fixture_ply.py).
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply")
# Fixture knobs: small enough for CI seconds, big enough to exercise depth
# layering, anisotropy, SH tilt, and multi-tile splats. max_dup=16 keeps
# the fixture truncation-free (exact for the scene's splat radii).
N, W, H, ORBIT = 20_000, 256, 256, 30.0


def render_golden(out_png: str, platform: str = "cpu") -> None:
    """Render the fixture through the CLI on `platform` ("cpu", "gpu", or
    "auto" for JAX's default device)."""
    sys.path.insert(0, REPO)
    from wgpu_3dgs_viewer_app_tpu.app.cli import main
    from wgpu_3dgs_viewer_app_tpu.data import read_ply, write_ply

    g = read_ply(FIXTURE)
    g = g.select((np.arange(g.count) < N))  # prefix crop (file is shuffled)
    with tempfile.NamedTemporaryFile(suffix=".ply", delete=False) as f:
        write_ply(f, g)
        ply_path = f.name
    try:
        rc = main([
            "--platform", platform, "render", ply_path, "-o", out_png,
            "--width", str(W), "--height", str(H),
            "--max-dup", "16", "--orbit", str(ORBIT),
        ])
        assert rc == 0
    finally:
        os.unlink(ply_path)


def load_png(path: str) -> np.ndarray:
    sys.path.insert(0, REPO)
    from wgpu_3dgs_viewer_app_tpu.utils.png import read_png

    return read_png(path).astype(np.int16)


# The golden's bound: sort ties and summation order differ across versions
# and platforms, so isolated pixels may move; drift moves the mean.
MAX_MEAN_U8, MAX_ABS_U8 = 1.0, 48


def main_cli(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--update" in argv:
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        render_golden(GOLDEN)
        print(f"wrote {GOLDEN}")
        return 0
    with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
        out = f.name
    try:
        render_golden(out)
        d = np.abs(load_png(out) - load_png(GOLDEN))
        print(f"golden diff: mean {d.mean():.3f} u8, max {d.max()} u8")
        ok = d.mean() < MAX_MEAN_U8 and d.max() <= MAX_ABS_U8
        return 0 if ok else 1
    finally:
        os.unlink(out)


if __name__ == "__main__":
    raise SystemExit(main_cli())
