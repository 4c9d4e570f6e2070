"""Smoke test of the render path on one NVIDIA GPU.

Runs in one process, on one card, through the entry points a user calls:

  a. device      JAX's devices and the card's name and power limit;
  b. cli         `cli render` of the committed fixture vs the CPU golden;
  c. frames      config 1 (6M splats, 1080p, SH3) and config 0 (50k, point
                 mode): frames through `MultiModelViewer.render`, the
                 Triton compositor vs `composite_tiles_jnp_v2` on the same
                 sorted entries, and the frame with each compositor;
  d. gated       configs 2, 3 and 4 (multi-model, selection edit, mask)
                 through `MultiModelViewer.render`;
  e. serve       an in-process `ViewerServer` answering /frame.png.

`--multi` runs only phase f instead: `render_sharded` and
`render_frame_sharded_multi` at config 1 over four GPUs against the
single-device render on the first.

Every phase prints what it found; any failure makes the exit code
non-zero. Without a GPU, or without the package beside this file, it
exits non-zero and prints no result. The last stdout line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

With `--out DIR` it also profiles two config 1 frames and writes the
per-kernel device time to DIR/kernels.tsv.

Usage: python chip_smoke.py [--multi] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel vs reference on premultiplied rgba: both are f32 elementwise math
# with no matrix product; only exp2 and summation order differ.
COMPOSITE_ATOL = 1e-4
# Sharded vs single-device frames (tests/test_parallel.py's bound).
SHARDED_MEAN, SHARDED_MAX = 1e-3, 0.05


class NoGpu(RuntimeError):
    pass


def _import_repo():
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import bench  # noqa: F401  (repo root: scene builders, timing)
    import gen_golden  # noqa: F401
    import wgpu_3dgs_viewer_app_tpu  # noqa: F401


def _check_image(img, name):
    """Finite, expected shape, and not blank."""
    import numpy as np

    a = np.asarray(img)
    assert np.isfinite(a).all(), f"{name}: non-finite pixels"
    covered = float((a.max(axis=-1) > 0.02).mean())
    assert covered > 0.01, f"{name}: blank frame ({covered:.4f} covered)"
    return covered


def _time(fn, iters, warmup=1):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# --- phases -----------------------------------------------------------------


def phase_device(require_gpu=True):
    import jax

    import bench

    devs = jax.devices()
    d = {"platform": devs[0].platform, "kind": devs[0].device_kind,
         "count": len(devs)}
    if require_gpu and d["platform"] != "gpu":
        raise NoGpu(f"JAX found no GPU (default device: {devs[0]})")
    d["card"] = bench.card_info() if require_gpu else "not measured"
    return d


def phase_cli(platform="gpu"):
    """The committed fixture through `cli render`, against the CPU golden
    with its own bound (tie order and summation order differ)."""
    import tempfile

    import gen_golden
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "render.png")
        gen_golden.render_golden(out, platform=platform)
        img = gen_golden.load_png(out)
    gold = gen_golden.load_png(gen_golden.GOLDEN)
    assert img.shape == gold.shape, (img.shape, gold.shape)
    d = np.abs(img - gold)
    res = {"mean_u8": float(d.mean()), "max_u8": int(d.max())}
    assert d.mean() < gen_golden.MAX_MEAN_U8 and d.max() <= gen_golden.MAX_ABS_U8, res
    return res


def phase_frames(name, n, w, h, sh_degree, mode, frames=3, g=None, iters=10,
                 plain_iters=3, kernel_interpret=False):
    """One config: viewer frames, kernel-vs-reference on the same sorted
    entries, and the whole frame with each compositor."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl
    from wgpu_3dgs_viewer_app_tpu.core.transform import GaussianDisplayMode, GaussianShDegree
    from wgpu_3dgs_viewer_app_tpu.ops import (
        build_sorted_entries,
        composite_tiles_gpu,
        composite_tiles_jnp_v2,
        preprocess,
    )
    from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer

    g = bench.scene(n) if g is None else g
    comp, pod, view, proj, cfg = bench.build(n, w, h, g=g)
    res = {}

    # Viewer frames: an orbit through the user-facing entry point.
    viewer = MultiModelViewer(w, h, tile=cfg.tile, max_dup=cfg.max_dup,
                              impl="cpu" if kernel_interpret else None)
    viewer.add_model("m", g)
    gt = viewer.gaussian_transform
    gt.sh_deg = GaussianShDegree(sh_degree)
    gt.display_mode = GaussianDisplayMode(mode)
    cams = [CameraOrbitControl(target=(0, 0, 0), pos=(6 * math.sin(a), 0.0, -6 * math.cos(a)))
            for a in np.linspace(0.0, 0.6, frames)]
    t0 = time.perf_counter()
    imgs = [viewer.render(c) for c in cams]
    jax.block_until_ready(imgs)
    res["viewer_first_frames_s"] = time.perf_counter() - t0
    res["covered"] = [_check_image(im, f"{name} frame {i}") for i, im in enumerate(imgs)]
    res["viewer_frame_ms"] = 1e3 * _time(lambda: viewer.render(cams[-1]), iters)

    # The compositor alone, on one set of sorted entries.
    @jax.jit
    def entries_fn(pod, view, proj):
        pre = preprocess(pod, comp, view, proj, jnp.eye(4), w, h,
                         sh_degree=sh_degree, display_mode=mode)
        return build_sorted_entries(pre, cfg)

    entries = entries_fn(pod, view, proj)
    flat = mode != 0
    ref = composite_tiles_jnp_v2(entries, cfg, flat_mode=flat)
    got = composite_tiles_gpu(entries, cfg, flat_mode=flat, interpret=kernel_interpret)
    err = float(jnp.max(jnp.abs(got - ref)))
    res["composite_max_abs"] = err
    res["entries_live"] = int(entries.n_valid)
    res["entries_slots"] = int(entries.planes.shape[0] * entries.planes.shape[2])
    assert err <= COMPOSITE_ATOL, f"{name}: kernel vs jnp max abs {err:.3g}"
    if not kernel_interpret:
        res["composite_kernel_ms"] = 1e3 * _time(
            lambda: composite_tiles_gpu(entries, cfg, flat_mode=flat), iters)
        res["composite_jnp_ms"] = 1e3 * _time(
            lambda: composite_tiles_jnp_v2(entries, cfg, flat_mode=flat), plain_iters)

        # Whole frames (the bench's step) with each compositor.
        step_k = bench.frame_fn(comp, cfg, sh_degree, mode, "gpu")
        t0 = time.perf_counter()
        compiled = step_k.lower(pod, view, proj).compile()
        res["frame_compile_s"] = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        res["frame_memory_bytes"] = {k: getattr(mem, k) for k in dir(mem)
                                     if k.endswith("_size_in_bytes")}
        res["frame_kernel_ms"] = 1e3 * bench.time_frames(step_k, (pod, view, proj), iters=iters)
        step_p = bench.frame_fn(comp, cfg, sh_degree, mode, "cpu")
        res["frame_plain_ms"] = 1e3 * bench.time_frames(
            step_p, (pod, view, proj), iters=plain_iters, warmup=1)
    res["peak_bytes_in_use"] = _peak_bytes()
    return res, g


def phase_gated(sizes=None, g6=None, iters=3):
    """Configs 2, 3 and 4 through `MultiModelViewer.render`."""
    import jax

    import bench

    sizes = sizes or {}
    res = {}
    builders = (
        ("config2", lambda: bench.config2_viewer(**sizes.get("config2", {}))),
        ("config3", lambda: bench.config3_viewer(**sizes.get("config3", {}))),
        ("config4", lambda: bench.config4_viewer(g=g6, **sizes.get("config4", {}))),
    )
    for name, build in builders:
        viewer, step = build()
        img = step()
        jax.block_until_ready(img)
        cfg = viewer.cfg
        assert img.shape == (cfg.height, cfg.width, 3), (name, img.shape)
        res[name] = {"covered": _check_image(img, name),
                     "frame_ms": 1e3 * _time(step, iters)}
        del viewer, step, img
    return res


def phase_serve(n=100_000, w=640, h=480, requests=3):
    """An in-process server on a free port answering /frame.png."""
    import io
    import urllib.request
    from http.server import ThreadingHTTPServer

    import bench
    from wgpu_3dgs_viewer_app_tpu.app.server import ViewerServer, make_handler
    from wgpu_3dgs_viewer_app_tpu.app.state import GaussianSplattingSession
    from wgpu_3dgs_viewer_app_tpu.data import write_ply
    from wgpu_3dgs_viewer_app_tpu.utils.png import decode_png

    buf = io.BytesIO()
    write_ply(buf, bench.scene(n))
    buf.seek(0)
    session = GaussianSplattingSession(w, h)
    session.open_model("scene.ply", buf)
    while session.loader is not None:
        session._drain_loader()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ViewerServer(session)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    times = []
    try:
        for i in range(requests):
            if i:
                req = urllib.request.Request(
                    base + "/event", method="POST",
                    data=json.dumps({"type": "orbit", "dx": 20.0, "dy": 0.0}).encode())
                urllib.request.urlopen(req, timeout=120).read()
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + "/frame.png", timeout=600) as r:
                assert r.headers["Content-Type"] == "image/png"
                img = decode_png(r.read())
            times.append(time.perf_counter() - t0)
            assert img.shape == (h, w, 3), img.shape
            assert img.max() > 0, "blank served frame"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return {"request_s": times}


def _image_diff(img, ref):
    import numpy as np

    d = np.abs(img - ref)
    return {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
            "px_over_max": float((d > SHARDED_MAX).any(-1).mean())}


def phase_multi(n=6_000_000, w=1920, h=1088, n_dev=4):
    """Config 1 over `n_dev` GPUs, both transports, vs one device.

    Equal keys sort in no fixed order, so two correct renders of one scene
    can blend tied entries differently at isolated pixels. The control
    renders the same scene with its splats permuted on one device and
    reports how far that moves pixels; a transport passes with no routing
    overflow, a mean error below SHARDED_MEAN, and no more pixels beyond
    SHARDED_MAX than the control shows (at least 1e-4 of them allowed)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from wgpu_3dgs_viewer_app_tpu.ops import (
        composite_tiles_v2,
        enumerate_entries_from_pre,
        over_background,
        preprocess,
        render_impl,
        sort_and_range_entries,
    )
    from wgpu_3dgs_viewer_app_tpu.parallel import (
        make_mesh,
        render_frame_sharded_multi,
        render_sharded,
        shard_pod,
    )
    from wgpu_3dgs_viewer_app_tpu.parallel.render_sharded import RAGGED_TRANSPORT

    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, found {len(devs)}"
    impl = render_impl(devs[0].platform)
    g = bench.scene(n)
    comp, pod, view, proj, cfg = bench.build(n, w, h, g=g)
    bg = jnp.zeros(3, jnp.float32)
    models = jnp.stack([jnp.eye(4), jnp.eye(4).at[2, 3].set(0.5)])
    ranks = jnp.asarray([1, 0], jnp.uint32)
    step = bench.frame_fn(comp, cfg, 3, 0, impl)

    def merged(pod):
        cfg_m = dataclasses.replace(cfg, model_bits=1)
        parts = []
        for i in range(2):
            pre = preprocess(pod, comp, view, proj, models[i], w, h, sh_degree=3)
            parts.append(enumerate_entries_from_pre(pre, cfg_m, model_rank=ranks[i]))
        ent = sort_and_range_entries(*(jnp.concatenate([p[j] for p in parts])
                                       for j in range(4)), cfg_m)
        return np.asarray(over_background(composite_tiles_v2(ent, cfg_m, False, impl), bg))

    ref = np.asarray(over_background(step(pod, view, proj), bg))
    ref_m = merged(pod)
    perm = np.random.default_rng(1).permutation(n)
    pod_p = bench.build(n, w, h, g=g.select(perm))[1]
    res = {"default_ragged": RAGGED_TRANSPORT[impl],
           "control": _image_diff(np.asarray(over_background(step(pod_p, view, proj), bg)), ref),
           "control_multi": _image_diff(merged(pod_p), ref_m)}
    del pod_p
    allowed = max(1e-4, res["control"]["px_over_max"])
    allowed_m = max(1e-4, res["control_multi"]["px_over_max"])

    mesh = make_mesh(devs[:n_dev])
    pod_s = shard_pod(pod, mesh)
    for ragged in (True, False):
        key = "ragged" if ragged else "all_to_all"
        try:
            img, stats = render_sharded(pod_s, mesh, comp, cfg, view, proj,
                                        ragged=ragged, return_stats=True)
            img_m, overflow = render_frame_sharded_multi(
                (pod_s, pod_s), mesh, "splats", comp, cfg, view, proj, models,
                ranks, bg, sh_degree=3, impl=impl, ragged=ragged)
            r = {"overflow": stats["overflow"], "overflow_multi": int(np.max(overflow)),
                 "single": _image_diff(np.asarray(img), ref),
                 "multi": _image_diff(np.asarray(img_m)[:h], ref_m)}
            r["frame_ms"] = 1e3 * _time(lambda: render_sharded(
                pod_s, mesh, comp, cfg, view, proj, ragged=ragged), 5)
            r["ok"] = (r["overflow"] == 0 and r["overflow_multi"] == 0
                       and r["single"]["mean_abs"] < SHARDED_MEAN
                       and r["multi"]["mean_abs"] < SHARDED_MEAN
                       and r["single"]["px_over_max"] <= allowed
                       and r["multi"]["px_over_max"] <= allowed_m)
        except Exception as e:  # noqa: BLE001 — both transports are reported
            r = {"ok": False, "error": f"{type(e).__name__}: {str(e)[:400]}"}
        res[key] = r
        print(f"[f multi] {key}: " + json.dumps(r), flush=True)
    res["single_frame_ms"] = 1e3 * _time(lambda: step(pod, view, proj), 5)
    default = "ragged" if res["default_ragged"] else "all_to_all"
    assert res[default]["ok"], f"default transport {default} failed: {res[default]}"
    return res


def trace_headline(out_dir, n=6_000_000, w=1920, h=1088):
    """Profile two config 1 frames; write per-kernel device time."""
    import glob

    import jax
    from jax.profiler import ProfileData

    import bench

    comp, pod, view, proj, cfg = bench.build(n, w, h)
    step = bench.frame_fn(comp, cfg, 3, 0, "gpu")
    jax.block_until_ready(step(pod, view, proj))
    tdir = os.path.join(out_dir, "trace")
    with jax.profiler.trace(tdir):
        for _ in range(2):
            jax.block_until_ready(step(pod, view, proj))
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True))[-1]
    rows = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            tot = {}
            for ev in line.events:
                t = tot.setdefault(ev.name, [0, 0.0])
                t[0] += 1
                t[1] += ev.duration_ns
            for name, (cnt, ns) in tot.items():
                rows.append((line.name, ns / 2e6, cnt // 2, name))
    rows.sort(key=lambda r: -r[1])
    with open(os.path.join(out_dir, "kernels.tsv"), "w") as f:
        f.write("line\tms_per_frame\tcalls_per_frame\tname\n")
        for r in rows:
            f.write("\t".join(str(x) for x in r) + "\n")
    return [f"{r[1]:.3f} ms x{r[2]} [{r[0]}] {r[3][:100]}" for r in rows[:25]]


# --- driver -----------------------------------------------------------------


def _run(name, fn, failures):
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — every phase is reported, then exit != 0
        traceback.print_exc()
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s: "
              f"{type(e).__name__}: {e}", flush=True)
        failures.append(name)
        return None
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def _show(name, res):
    print(f"[{name}] " + json.dumps(res, default=str), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--out", default=None,
                    help="directory for long output: a config 1 profile")
    args = ap.parse_args(argv)
    try:
        _import_repo()
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", os.path.join(REPO, ".jax_cache"))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    failures = []
    try:
        device = phase_device()
    except NoGpu as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3
    _show("a device", device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if args.multi:
        res = _run("f multi", phase_multi, failures)
        if res:
            _show("f multi", res)
    else:
        res = _run("b cli", phase_cli, failures)
        if res:
            _show("b cli", res)
        g1 = None
        out = _run("c config1", lambda: phase_frames(
            "config1", 6_000_000, 1920, 1088, 3, 0), failures)
        if out:
            _show("c config1", {"card": device["card"], **out[0]})
            g1 = out[1]
        out = _run("c config0", lambda: phase_frames(
            "config0", 50_000, 800, 608, 0, 2), failures)
        if out:
            _show("c config0", {"card": device["card"], **out[0]})
        res = _run("d gated", lambda: phase_gated(g6=g1), failures)
        if res:
            _show("d gated", res)
        res = _run("e serve", phase_serve, failures)
        if res:
            _show("e serve", res)
        if args.out:
            res = _run("trace", lambda: trace_headline(args.out), failures)
            for line in res or ():
                print(f"[trace] {line}", flush=True)
    print(f"card: {device['card']}", flush=True)
    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": device["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
