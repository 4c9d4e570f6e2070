"""Quality-preset curve: fps AND image error per max_dup, one dated sweep.

Error bounds and fps of each dup preset come from ONE run, so a
published table is auditable. Two parts:

  * speed: the headline frame (6M splats, 1080p, SH3, bench.py's exact
    build/frame/timing helpers) at max_dup in {4, 8, 16};
  * error: trained-statistics 300k scene (make_inria_like_scene, the
    fidelity fixture of tests/test_image_gpu.py) at 1080p, each dup level
    vs the dup=16 render — mean |err| and p99.9 in u8 units. The
    dup-truncation mechanism (clipped far tile corners of splats spanning
    more than max_dup tiles) is scale-free, so the small scene's error
    transfers to the 6M headline.

Run on a GPU:  python scripts/bench_dup_curve.py
"""

import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from bench import build, card_info, device_info, frame_fn, time_frames
from wgpu_3dgs_viewer_app_tpu.ops import render_impl


def main():
    impl = render_impl()
    print(f"device={device_info()} card={card_info()}  dup curve "
          f"{time.strftime('%Y-%m-%d')}", flush=True)

    # --- speed at headline scale (one scene build, vary dup only) ---
    comp, pod, view, proj, cfg = build(6_000_000, 1920, 1088)
    for dup in (4, 8, 16):
        cfg_d = dataclasses.replace(cfg, max_dup=dup)
        step = frame_fn(comp, cfg_d, 3, 0, impl)
        dt = time_frames(step, (pod, view, proj), iters=8)
        print(f"speed  dup={dup:2d}: {dt*1e3:7.2f} ms = {1/dt:5.1f} fps",
              flush=True)

    # --- error vs dup=16, trained-statistics fidelity fixture ---
    from wgpu_3dgs_viewer_app_tpu.data import make_inria_like_scene, pack_gaussians
    import jax.numpy as jnp

    g = make_inria_like_scene(300_000, seed=5)
    podq = {k: jnp.asarray(v) for k, v in pack_gaussians(g, comp).items()}
    imgs = {}
    for dup in (16, 8, 4, 3, 2):
        cfg_q = dataclasses.replace(cfg, max_dup=dup)
        step = frame_fn(comp, cfg_q, 3, 0, impl)
        imgs[dup] = np.asarray(step(podq, view, proj))[..., :3] * 255.0
    ref = imgs[16]
    for dup in (8, 4, 3, 2):
        d = np.abs(imgs[dup] - ref)
        print(f"error  dup={dup:2d} vs 16: mean |err| = {d.mean():.4f} u8, "
              f"p99.9 = {np.percentile(d, 99.9):.2f} u8, max = {d.max():.1f}",
              flush=True)


if __name__ == "__main__":
    main()
