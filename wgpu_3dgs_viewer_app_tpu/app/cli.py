"""Command-line entry points: offline rendering and the interactive server.

Usage:
  python -m wgpu_3dgs_viewer_app_tpu.app.cli render model.ply -o out.png \
      [--width 1920 --height 1080 --sh-deg 3 --mode splat --orbit 30]
  python -m wgpu_3dgs_viewer_app_tpu.app.cli serve [model.ply ...] \
      [--port 8080 --width 1280 --height 720]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from ..utils.png import to_u8, write_png


def _save_png(path: str, img: np.ndarray) -> None:
    write_png(path, to_u8(img))


def cmd_render(args) -> int:
    from ..core.camera import CameraOrbitControl
    from ..core.transform import GaussianDisplayMode, GaussianShDegree
    from ..data.compression import Compressions, Cov3dCompression, ShCompression
    from ..data.ply import read_ply
    from ..viewer.viewer import Viewer

    g = read_ply(args.model)
    print(f"loaded {g.count:,} splats from {args.model}", file=sys.stderr)
    comp = Compressions(ShCompression(args.sh_comp), Cov3dCompression(args.cov3d_comp))
    v = Viewer(g, args.width, args.height, comp=comp, background=tuple(args.background),
               tile=args.tile, max_dup=args.max_dup)
    gt = v.gaussian_transform
    gt.sh_deg = GaussianShDegree(args.sh_deg)
    gt.display_mode = GaussianDisplayMode[args.mode.upper()]
    gt.size = args.size

    center = g.center()
    extent = float(np.abs(g.pos - center).max()) or 1.0
    dist = args.distance or extent * 2.0

    def cam_at(deg):
        yaw = math.radians(deg)
        return CameraOrbitControl(
            target=center,
            pos=center + dist * np.array(
                [math.sin(yaw), 0.3, math.cos(yaw)], np.float32),
        )

    if args.frames <= 1:
        img = v.render(cam_at(args.orbit))
        _save_png(args.output, np.asarray(img))
        print(f"wrote {args.output}", file=sys.stderr)
        return 0

    # Orbit sequence: frames are ENQUEUED back-to-back (jax dispatch is
    # async) and pulled to the host in order — the interactive pipelining
    # the bench measures, exposed as a batch renderer. Output name gets a
    # frame index: out.png -> out_000.png ...
    import time as _time

    stem, dot, ext = args.output.rpartition(".")
    if not dot:
        stem, ext = args.output, "png"
    t0 = _time.perf_counter()
    imgs = [v.render(cam_at(args.orbit + i * args.orbit_step))
            for i in range(args.frames)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(f"{stem}_{i:03d}.{ext}")
        _save_png(paths[-1], np.asarray(img))
    dt = _time.perf_counter() - t0
    print(f"wrote {len(paths)} frames ({paths[0]} .. {paths[-1]}) in "
          f"{dt:.2f}s = {len(paths) / dt:.1f} fps incl. PNG encode",
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from ..data.compression import Compressions, Cov3dCompression, ShCompression
    from .server import serve
    from .state import GaussianSplattingSession

    comp = Compressions(ShCompression(args.sh_comp), Cov3dCompression(args.cov3d_comp))
    session = GaussianSplattingSession(args.width, args.height, compressions=comp,
                                       tile=args.tile, max_dup=args.max_dup)
    for path in args.models:
        with open(path, "rb") as f:
            session.open_model(path.split("/")[-1], f)
            while session.loader is not None:
                session._drain_loader()
    serve(session, host=args.host, port=args.port)
    return 0


def main(argv=None) -> int:
    from ..utils.log import configure

    configure()  # $GS_LOG=debug|info|... (env_logger analog)
    ap = argparse.ArgumentParser(prog="3dgs-viewer")
    ap.add_argument(
        "--platform", choices=["auto", "cpu", "gpu"], default="auto",
        help="pin the JAX backend (auto: JAX's default device)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="offline render a PLY to PNG")
    r.add_argument("model")
    r.add_argument("-o", "--output", default="out.png")
    r.add_argument("--width", type=int, default=1280)
    r.add_argument("--height", type=int, default=720)
    r.add_argument("--sh-deg", type=int, default=3)
    r.add_argument("--mode", choices=["splat", "ellipse", "point"], default="splat")
    r.add_argument("--size", type=float, default=1.0)
    r.add_argument("--orbit", type=float, default=0.0, help="orbit yaw degrees")
    r.add_argument("--frames", type=int, default=1,
                   help="render an orbit sequence of N frames (out_%%03d.png)")
    r.add_argument("--orbit-step", type=float, default=2.0,
                   help="yaw degrees between sequence frames")
    r.add_argument("--distance", type=float, default=None)
    r.add_argument("--background", type=float, nargs=3, default=[0, 0, 0])
    r.add_argument("--sh-comp", default="norm8", choices=["single", "half", "norm8", "remove"])
    r.add_argument("--cov3d-comp", default="half", choices=["single", "half"])
    r.add_argument("--tile", type=int, default=32, help="screen tile size (px)")
    r.add_argument("--max-dup", type=int, default=4,
                   help="tile entries per splat (4=product default, bounded truncation on "
                        "splats spanning >2x2 tiles; 8/16=quality presets)")
    r.set_defaults(fn=cmd_render)

    s = sub.add_parser("serve", help="interactive web viewer")
    s.add_argument("models", nargs="*")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--width", type=int, default=1280)
    s.add_argument("--height", type=int, default=720)
    s.add_argument("--sh-comp", default="norm8", choices=["single", "half", "norm8", "remove"])
    s.add_argument("--cov3d-comp", default="half", choices=["single", "half"])
    s.add_argument("--tile", type=int, default=32, help="screen tile size (px)")
    s.add_argument("--max-dup", type=int, default=4,
                   help="tile entries per splat (4=product default, bounded truncation on "
                        "splats spanning >2x2 tiles; 8/16=quality presets)")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    import jax

    # Persistent compile cache (repo-local, shared with bench.py and
    # chip_smoke.py) so repeated invocations skip recompiling the frame.
    # Redirect with JAX_COMPILATION_CACHE_DIR.
    try:
        cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:  # already-initialized in-process callers
        pass
    if args.platform != "auto":
        try:
            jax.config.update("jax_platforms", args.platform)
        except Exception as e:
            # In-process callers (tests, notebooks) may have initialized the
            # backend already; the update can raise then. Proceed on the
            # live backend rather than dying (standalone CLI never hits
            # this — it pins before first device touch).
            print(f"--platform {args.platform} ignored: {e}", file=sys.stderr)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
