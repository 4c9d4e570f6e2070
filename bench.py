"""Benchmark harness — BASELINE.json configs on one NVIDIA GPU.

Prints one summary JSON line after every config; the last line is the
whole run:
  {"metric": "fps_1080p_6m_splats", "value": N, "unit": "fps",
   "vs_baseline": N, "configs": {...}, "device": {...}, "errors": {...}}

vs_baseline is against the 60 FPS @1080p target on a ~6M-splat scene
(BASELINE.md; the reference publishes no numbers). `device` names the
platform, device kind and count JAX reported, and the card's name and
power limit from nvidia-smi.

Each config runs in its own child process (`--config N`), one at a time:
a JAX process reserves most of the card's memory, so the parent never
touches the device. A child that finds no GPU fails; there is no CPU
fallback.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp

_CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".jax_cache"
)
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """The device as JAX reports it; raises when the default is not a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {devs[0]}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# --- scenes (BASELINE.json configs) ----------------------------------------

# Config 3's gesture: rect selection, selection colour edit and highlight.
SEL_RECT = ((400.0, 200.0), (1400.0, 800.0))
SEL_EDIT = dict(flags=1, rgb_or_hsv=(0.15, 1.2, 1.0), contrast=0.1,
                exposure=0.2, gamma=1.0, alpha=1.0)
HIGHLIGHT = (1.0, 0.0, 1.0, 0.4)
# Config 4's mask expression over three shapes.
MASK_EXPR = "(0 | 1) - 2"


def scene(n, seed=0):
    from wgpu_3dgs_viewer_app_tpu.data import make_random_scene

    return make_random_scene(n, seed=seed, extent=2.0, scale_range=(0.004, 0.02))


def camera():
    from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl

    return CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))


def build(n, w, h, tile=32, max_dup=4, seed=0, g=None):
    """(comp, pod, view, proj, cfg) for a uniform random scene of n splats."""
    from wgpu_3dgs_viewer_app_tpu.data import Compressions, pack_gaussians
    from wgpu_3dgs_viewer_app_tpu.ops import TileConfig

    comp = Compressions()
    g = scene(n, seed) if g is None else g
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(g, comp).items()}
    cam = camera()
    view = jnp.asarray(cam.view())
    proj = jnp.asarray(cam.projection(w / h))
    return comp, pod, view, proj, TileConfig(w, h, tile=tile, max_dup=max_dup)


def frame_fn(comp, cfg, sh_degree, display_mode, impl):
    """One model's frame (preprocess -> enumerate -> sort -> composite)."""
    from wgpu_3dgs_viewer_app_tpu.ops import (
        build_sorted_entries,
        composite_tiles_v2,
        preprocess,
    )

    @jax.jit
    def step(pod, view, proj):
        pre = preprocess(
            pod, comp, view, proj, jnp.eye(4), cfg.width, cfg.height,
            sh_degree=sh_degree, display_mode=display_mode,
        )
        entries = build_sorted_entries(pre, cfg)
        return composite_tiles_v2(entries, cfg, display_mode != 0, impl)

    return step


def time_frames(step, args, iters=10, warmup=2):
    """Pipelined seconds per frame: `iters` frames enqueued back to back,
    the last one waited on (the device runs its stream in order)."""
    for _ in range(warmup):
        jax.block_until_ready(step(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = step(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def config2_viewer(impl=None, n=1_000_000, w=1920, h=1088):
    """Config 2: 3 x 1M models with per-model transforms and colour edits.
    Returns (viewer, step); step() renders one frame."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl, ModelTransform
    from wgpu_3dgs_viewer_app_tpu.core.edit import EDIT_FLAG_ENABLED
    from wgpu_3dgs_viewer_app_tpu.data import make_random_scene
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer

    viewer = MultiModelViewer(w, h, tile=32, max_dup=4, impl=impl)
    placements = ((-2.0, 0.0), (0.0, 40.0), (2.0, -40.0))
    for i, (dxx, rot) in enumerate(placements):
        g = make_random_scene(n, seed=i, extent=1.5, scale_range=(0.004, 0.02))
        m = viewer.add_model(f"m{i}", g)
        viewer.update_model_transform(
            f"m{i}",
            ModelTransform(
                pos=np.array([dxx, 0.0, 0.0], np.float32),
                rot=np.array([0.0, rot, 0.0], np.float32),
            ),
        )
        # Per-model color edit: hue shift + saturation scale on every splat.
        n = m.buffers.edit_flags.shape[0]
        m.buffers.set_edits(
            jnp.full(n, EDIT_FLAG_ENABLED, jnp.uint32),
            jnp.broadcast_to(jnp.asarray([0.08 * i, 1.1, 1.0], jnp.float32), (n, 3)),
            m.buffers.edit_params,
        )
    viewer.update_camera(CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -7)))
    return viewer, viewer.render


def config3_viewer(impl=None, n=2_000_000, w=1920, h=1088):
    """Config 3: 2M splats; each frame runs the rect-selection pass (a
    degree-0 preprocess, as the app's query path does) and renders with the
    selection edit and highlight."""
    from wgpu_3dgs_viewer_app_tpu.core.edit import GaussianEditPod, SelectionHighlightPod
    from wgpu_3dgs_viewer_app_tpu.ops import preprocess
    from wgpu_3dgs_viewer_app_tpu.query import select_rect
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer

    viewer = MultiModelViewer(w, h, tile=32, max_dup=4, impl=impl)
    m = viewer.add_model("m", scene(n))
    viewer.update_camera(camera())
    viewer.update_selection_edit(GaussianEditPod(**SEL_EDIT))
    viewer.update_selection_highlight(SelectionHighlightPod(HIGHLIGHT), True)

    @jax.jit
    def select(pod, view, proj):
        pre = preprocess(pod, viewer.comp, view, proj, jnp.eye(4), w, h,
                         sh_degree=0)
        return select_rect(pre, *SEL_RECT)

    def step():
        m.buffers.set_selection(select(m.buffers.pod, viewer._view, viewer._proj))
        return viewer.render()

    return viewer, step


def config4_viewer(impl=None, n=6_000_000, w=1920, h=1088, g=None):
    """Config 4: 6M splats gated by a composite shape mask. `g` reuses an
    already generated scene of the same seed."""
    import numpy as np

    from wgpu_3dgs_viewer_app_tpu.mask import MaskEvaluator, MaskShape, MaskShapeKind, parse
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer

    viewer = MultiModelViewer(w, h, tile=32, max_dup=4, impl=impl)
    m = viewer.add_model("m", scene(n) if g is None else g)
    viewer.update_camera(camera())
    shapes = [
        MaskShape(kind=MaskShapeKind.BOX, pos=(0, 0, 0), scale=(1.5, 1.5, 1.5)).to_pod(),
        MaskShape(kind=MaskShapeKind.ELLIPSOID, pos=(0.5, 0, 0), scale=(1.0, 1.0, 1.0)).to_pod(),
        MaskShape(kind=MaskShapeKind.BOX, pos=(-0.5, 0.4, 0), scale=(0.6, 0.6, 0.6)).to_pod(),
    ]
    # Component planes straight from the pod's (3, R, 128) storage.
    pr = np.asarray(m.buffers.pod["pos"], np.float32).reshape(3, -1)
    bits = jax.jit(lambda x, y, z: MaskEvaluator().evaluate(parse(MASK_EXPR), shapes, (x, y, z)))(
        *(jnp.asarray(pr[i]) for i in range(3)))
    m.buffers.set_mask(bits)
    return viewer, viewer.render


# --- configs ---------------------------------------------------------------


def bench_config0(results):
    """Config 0: 50k splats, 800x608, point mode, SH0."""
    from wgpu_3dgs_viewer_app_tpu.ops import render_impl

    comp, pod, view, proj, cfg = build(50_000, 800, 608)
    dt = time_frames(frame_fn(comp, cfg, 0, 2, render_impl()), (pod, view, proj))
    results["config0_50k_point_fps"] = 1.0 / dt
    log(f"config0 (50k point 800x608): {dt*1000:.3f} ms")


def bench_config1(results):
    """Config 1 (the headline): 6M splats, 1080p, SH3, splat mode, at the
    product default (tile 32, max_dup 4), then the max_dup 8 quality row."""
    from wgpu_3dgs_viewer_app_tpu.ops import render_impl

    comp, pod, view, proj, cfg = build(6_000_000, 1920, 1088)
    dt = time_frames(frame_fn(comp, cfg, 3, 0, render_impl()), (pod, view, proj))
    results["config1_6m_1080p_fps"] = 1.0 / dt
    log(f"config1 (6M 1080p SH3, tile 32, dup 4): {dt*1000:.3f} ms")
    cfg8 = dataclasses.replace(cfg, max_dup=8)
    dt8 = time_frames(frame_fn(comp, cfg8, 3, 0, render_impl()), (pod, view, proj), iters=8)
    results["config1_quality_dup8_fps"] = 1.0 / dt8
    log(f"config1 quality preset (dup 8): {dt8*1000:.3f} ms")


def bench_config2(results):
    _, step = config2_viewer()
    dt = time_frames(step, (), iters=6)
    results["config2_multimodel_fps"] = 1.0 / dt
    log(f"config2 (3x1M multi-model 1080p): {dt*1000:.3f} ms")


def bench_config3(results):
    _, step = config3_viewer()
    dt = time_frames(step, (), iters=8)
    results["config3_selection_edit_fps"] = 1.0 / dt
    log(f"config3 (2M rect-select + edit 1080p): {dt*1000:.3f} ms")


def bench_config4(results):
    _, step = config4_viewer()
    dt = time_frames(step, (), iters=8)
    results["config4_masked_6m_fps"] = 1.0 / dt
    log(f"config4 (6M mask-gated 1080p): {dt*1000:.3f} ms")


CONFIG_FNS = {
    "0": bench_config0,
    "1": bench_config1,
    "2": bench_config2,
    "3": bench_config3,
    "4": bench_config4,
}
PLAN = (("1", 900), ("0", 300), ("2", 900), ("3", 600), ("4", 900))


def run_single(config: str) -> None:
    """Child: run one config; print {"ok", "device", "results"|"error"}."""
    out = {"ok": True, "results": {}}
    try:
        out["device"] = device_info()
        CONFIG_FNS[config](out["results"])
    except Exception as e:  # noqa: BLE001 — the parent reports it
        traceback.print_exc(file=sys.stderr)
        out = {"ok": False, "error": f"{type(e).__name__}: {e}",
               "results": out["results"], "device": out.get("device")}
    print(json.dumps(out), flush=True)


def _run_child(config: str, timeout: float) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--config", config]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE, timeout=timeout, text=True)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"timeout after {timeout:.0f}s", "results": {}}
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    try:
        return json.loads(lines[-1])
    except (IndexError, ValueError):
        return {"ok": False, "error": f"no result (rc={p.returncode})", "results": {}}


def orchestrate() -> int:
    """Parent: run each config in a child; print the summary after each."""
    results, errors = {}, {}
    device = {"card": card_info()}
    for config, timeout in PLAN:
        r = _run_child(config, timeout)
        results.update(r.get("results", {}))
        if r.get("device"):
            device.update(r["device"])
        if not r.get("ok"):
            errors[f"config{config}"] = r.get("error", "?")
        fps = results.get("config1_6m_1080p_fps", 0.0)
        summary = {
            "metric": "fps_1080p_6m_splats",
            "value": fps,
            "unit": "fps",
            "vs_baseline": fps / 60.0,
            "configs": results,
            "device": device,
        }
        if errors:
            summary["errors"] = errors
        print(json.dumps(summary), flush=True)
    return 1 if errors else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="child mode: run ONE config (0-4) and print its JSON")
    args = ap.parse_args()
    if args.config is not None:
        run_single(args.config)
        return 0
    return orchestrate()


if __name__ == "__main__":
    sys.exit(main())
