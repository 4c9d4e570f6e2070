"""Golden-image gate: the committed PNG artifact that pins image formation.

Renders the deterministic fixture scene through the CLI path and compares
against tests/golden/golden_256.png.
Regenerate intentionally with `python scripts/gen_golden.py --update`.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def assert_golden_close(img, gold):
    """The CPU golden gate, shared with the negative test below.

    Tolerances absorb cross-version XLA:CPU rounding (ties in the
    unstable sort can flip same-key blend order on isolated pixels)
    while failing loudly on real drift: a constant change, enumeration
    bug, or kernel regression moves the mean by >> 1 u8 step; localized
    regressions (a wrong tile, a shifted hue cluster) trip the per-tile
    structural bound even when globally rare."""
    assert img.shape == gold.shape
    d = np.abs(img.astype(np.float64) - gold.astype(np.float64))
    assert d.mean() < 1.0, f"golden drift: mean {d.mean():.3f} u8"
    assert d.max() <= 48, f"golden drift: max {d.max()} u8"
    assert (d > 8).mean() < 0.005, \
        f"golden drift: {100 * (d > 8).mean():.2f}% pixels off"
    # Structural bound: per-16x16-tile mean error. Legit tie-flips are
    # ISOLATED pixels (one 48-u8 pixel in a 256-px tile contributes 0.19);
    # any clustered regression — a hue shift over a region, a broken tile,
    # a seam — concentrates error and blows past 3 u8.
    h, w = d.shape[:2]
    th, tw = h // 16, w // 16
    tiles = d[: th * 16, : tw * 16].reshape(th, 16, tw, 16, -1)
    tile_mean = tiles.mean(axis=(1, 3, 4))
    assert tile_mean.max() <= 3.0, (
        f"golden drift: tile mean {tile_mean.max():.2f} u8 at "
        f"tile {np.unravel_index(tile_mean.argmax(), tile_mean.shape)}")


def test_golden_image_matches(tmp_path):
    import gen_golden

    out = str(tmp_path / "render.png")
    gen_golden.render_golden(out)
    img = gen_golden.load_png(out)
    gold = gen_golden.load_png(gen_golden.GOLDEN)
    assert_golden_close(img, gold)


def test_golden_gate_fails_on_injected_hue_shift():
    """Negative control: a 2%-pixel hue shift — the
    class of subtle minority-pixel color regression the old tolerances
    could pass — must FAIL the gate."""
    import gen_golden

    gold = gen_golden.load_png(gen_golden.GOLDEN)
    img = gold.copy().astype(np.int16)
    rng = np.random.default_rng(0)
    mask = rng.random(img.shape[:2]) < 0.02
    img[mask, 0] = np.clip(img[mask, 0] + 12, 0, 255)  # +12 u8 red shift
    with pytest.raises(AssertionError):
        assert_golden_close(img.astype(gold.dtype), gold)

    # And a CLUSTERED regression rare enough (< 0.5% of pixels) to slip the
    # global percentile bound must trip the per-tile structural bound.
    img2 = gold.copy().astype(np.int16)
    img2[16:32, 16:32] = np.clip(img2[16:32, 16:32] + 40, 0, 255)
    with pytest.raises(AssertionError):
        assert_golden_close(img2.astype(gold.dtype), gold)


@pytest.mark.gpu
def test_golden_image_matches_gpu(gpu, tmp_path):
    """The fixture rendered through the CLI on the card, with the Triton
    compositor, against the committed CPU golden under the golden's own
    bound: sort ties and summation order differ across platforms, so
    isolated pixels may move while the mean holds."""
    import gen_golden

    out = str(tmp_path / "render_gpu.png")
    gen_golden.render_golden(out, platform="gpu")
    d = np.abs(gen_golden.load_png(out) - gen_golden.load_png(gen_golden.GOLDEN))
    assert d.mean() < gen_golden.MAX_MEAN_U8, f"mean {d.mean():.3f} u8"
    assert d.max() <= gen_golden.MAX_ABS_U8, f"max {d.max()} u8"
