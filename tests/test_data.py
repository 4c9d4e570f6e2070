"""Data layer tests: PLY round-trip, compression configs, size math.

Reference test strategy is absent (SURVEY §4) — these cover the pure logic
the reference has as testable functions: PLY round-trip (`src/app.rs:896-947`)
and compressed-size math (`src/app.rs:352-384`).
"""

import io

import numpy as np
import pytest

from wgpu_3dgs_viewer_app_tpu.data import (
    ALL_COMPRESSIONS,
    Compressions,
    Cov3dCompression,
    PLY_GAUSSIAN_POD_SIZE,
    ShCompression,
    make_random_scene,
    pack_gaussians,
    read_ply,
    read_ply_chunks,
    read_ply_header,
    unpack_color0,
    unpack_cov3d,
    unpack_sh,
    write_ply,
)
from wgpu_3dgs_viewer_app_tpu.data.gaussian import Gaussians


def test_pod_size_is_248_bytes():
    assert PLY_GAUSSIAN_POD_SIZE == 248  # ref PlyGaussianPod (62 f32)


def test_pod_records_roundtrip():
    g = make_random_scene(100, seed=3)
    rec = g.to_pod_records()
    g2 = Gaussians.from_pod_records(rec)
    for f in ("pos", "normal", "sh0", "sh_rest", "opacity", "scale", "rot"):
        np.testing.assert_array_equal(getattr(g, f), getattr(g2, f))


def test_ply_write_read_roundtrip():
    g = make_random_scene(257, seed=1)
    buf = io.BytesIO()
    n = write_ply(buf, g)
    assert n == 257
    buf.seek(0)
    g2 = read_ply(buf)
    np.testing.assert_allclose(g.pos, g2.pos, rtol=0, atol=0)
    np.testing.assert_allclose(g.sh_rest, g2.sh_rest)
    np.testing.assert_allclose(g.rot, g2.rot)


def test_ply_header_first_streaming():
    g = make_random_scene(1000, seed=2)
    buf = io.BytesIO()
    write_ply(buf, g)
    buf.seek(0)
    header = read_ply_header(buf)
    assert header.count == 1000  # count known before any splat is read
    chunks = list(read_ply_chunks(buf, header, chunk_size=300))
    assert [c.count for c in chunks] == [300, 300, 300, 100]
    merged = Gaussians.concat(chunks)
    np.testing.assert_array_equal(merged.pos, g.pos)


def test_ply_mask_filter_on_export():
    g = make_random_scene(50, seed=4)
    mask = np.zeros(50, bool)
    mask[:20] = True
    buf = io.BytesIO()
    n = write_ply(buf, g, mask=mask)
    assert n == 20
    buf.seek(0)
    g2 = read_ply(buf)
    np.testing.assert_array_equal(g2.pos, g.pos[:20])


def test_ply_rejects_garbage():
    from wgpu_3dgs_viewer_app_tpu.data import PlyError

    with pytest.raises(PlyError):
        read_ply_header(io.BytesIO(b"not a ply\n"))


@pytest.mark.parametrize("header", [
    b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n",  # no end_header
    b"ply\nformat binary_little_endian 1.0\nend_header\n",        # no element
    b"ply\nformat klingon 1.0\nelement vertex 4\nend_header\n",   # bad format
    b"ply\nelement vertex 4\nend_header\n",                       # no format line
    b"ply\nformat binary_little_endian 1.0\nelement vertex -3\n"
    b"property float x\nend_header\n",                            # negative count
], ids=["no-end", "no-element", "bad-format", "no-format", "negative-count"])
def test_ply_header_fuzz_rejected(header):
    """Malformed headers raise PlyError (never a crash or silent garbage) —
    reference logs per-record errors but a broken header kills the load
    (/root/reference/src/tab/scene.rs:340-356 semantics)."""
    from wgpu_3dgs_viewer_app_tpu.data import PlyError

    with pytest.raises((PlyError, ValueError)):
        read_ply_header(io.BytesIO(header))


def test_compressed_sizes_ordering():
    # Default = Norm8 SH + Half cov3d (ref src/app.rs:398-417).
    default = Compressions()
    assert default.sh == ShCompression.NORM8
    assert default.cov3d == Cov3dCompression.HALF
    full = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)
    none = Compressions(ShCompression.REMOVE, Cov3dCompression.HALF)
    n = 1000
    assert none.compressed_size(n) < default.compressed_size(n) < full.compressed_size(n)
    # All 8 configs exist and shrink vs the raw pod.
    assert len(ALL_COMPRESSIONS) == 8
    for c in ALL_COMPRESSIONS:
        assert c.compressed_size(n) < n * PLY_GAUSSIAN_POD_SIZE


@pytest.mark.parametrize("comp", ALL_COMPRESSIONS, ids=lambda c: f"{c.sh.value}-{c.cov3d.value}")
def test_pack_unpack_fidelity(comp):
    import jax.numpy as jnp

    g = make_random_scene(64, seed=5)
    # Rows layout pads the splat axis to the 128-lane width; padded splats
    # must decode to alpha 0 (never rendered).
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(g, comp).items()}
    rgb, alpha = unpack_color0(pod)
    assert rgb.shape == (128, 3) and alpha.shape == (128,)
    np.testing.assert_array_equal(np.asarray(alpha[64:]), 0)
    sh = np.asarray(unpack_sh(pod, comp))[:64]
    if comp.sh == ShCompression.SINGLE:
        np.testing.assert_allclose(sh, g.sh_rest, atol=1e-6)
    elif comp.sh == ShCompression.HALF:
        np.testing.assert_allclose(sh, g.sh_rest, atol=2e-3)
    elif comp.sh == ShCompression.NORM8:
        span = np.ptp(g.sh_rest.reshape(64, -1), axis=1).max()
        np.testing.assert_allclose(sh, g.sh_rest, atol=span / 255 + 1e-6)
    else:
        np.testing.assert_array_equal(sh, 0)
    cov = np.asarray(unpack_cov3d(pod))[:64]
    flat_cov = pack_gaussians(g, comp, layout="flat")["cov3d"].astype(np.float32).T
    tol = 0 if comp.cov3d.value == "single" else 1e-3
    np.testing.assert_allclose(cov, flat_cov, atol=tol * max(1.0, abs(flat_cov).max()))


def test_bake_edits_hidden_and_alpha():
    import jax.numpy as jnp  # noqa: F401
    from wgpu_3dgs_viewer_app_tpu.core import (
        EDIT_FLAG_ENABLED,
        EDIT_FLAG_HIDDEN,
    )
    from wgpu_3dgs_viewer_app_tpu.data import bake_edits, sigmoid

    g = make_random_scene(10, seed=6)
    flags = np.zeros(10, np.uint32)
    flags[0] = EDIT_FLAG_ENABLED | EDIT_FLAG_HIDDEN
    flags[1] = EDIT_FLAG_ENABLED
    rgb = np.tile(np.array([0.0, 1.0, 1.0], np.float32), (10, 1))
    params = np.tile(np.array([0.0, 0.0, 1.0, 0.5], np.float32), (10, 1))  # alpha 0.5
    out, keep = bake_edits(g, flags, rgb, params)
    assert not keep[0] and keep[1:].all()
    np.testing.assert_allclose(
        sigmoid(out.opacity[1]), sigmoid(g.opacity[1]) * 0.5, rtol=1e-4
    )
    # untouched splats identical
    np.testing.assert_array_equal(out.opacity[2:], g.opacity[2:])


def _ply_bytes(g):
    buf = io.BytesIO()
    write_ply(buf, g)
    return buf.getvalue()


def test_ply_corrupt_records_skipped_not_fatal():
    """A corrupt-in-the-middle PLY loads the valid remainder, counting the
    skipped records (ref `src/tab/scene.rs:352-356` logs-and-skips)."""
    from wgpu_3dgs_viewer_app_tpu.data import PlyReadStats

    g = make_random_scene(300, seed=7)
    raw = bytearray(_ply_bytes(g))
    header_len = raw.index(b"end_header\n") + len(b"end_header\n")
    rec_size = 62 * 4
    # Poison records 50 and 199 with NaNs across their whole payload.
    for bad in (50, 199):
        start = header_len + bad * rec_size
        raw[start:start + rec_size] = np.full(62, np.nan, "<f4").tobytes()
    stats = PlyReadStats()
    g2 = read_ply(io.BytesIO(bytes(raw)), stats)
    assert g2.count == 298
    assert stats.skipped == 2
    assert stats.truncated == 0
    keep = np.ones(300, bool)
    keep[[50, 199]] = False
    np.testing.assert_array_equal(g2.pos, g.pos[keep])


def test_ply_truncated_tail_yields_valid_prefix():
    from wgpu_3dgs_viewer_app_tpu.data import PlyReadStats

    g = make_random_scene(200, seed=8)
    raw = _ply_bytes(g)
    header_len = raw.index(b"end_header\n") + len(b"end_header\n")
    cut = raw[: header_len + 120 * 62 * 4 + 17]  # mid-record truncation
    stats = PlyReadStats()
    g2 = read_ply(io.BytesIO(cut), stats)
    assert g2.count == 120
    assert stats.truncated == 80
    np.testing.assert_array_equal(g2.pos, g.pos[:120])


def test_ply_big_endian_roundtrip():
    """The byteswap path: a big-endian PLY decodes identically."""
    g = make_random_scene(128, seed=9)
    raw = _ply_bytes(g)
    header_len = raw.index(b"end_header\n") + len(b"end_header\n")
    head = raw[:header_len].replace(b"binary_little_endian", b"binary_big_endian")
    body = np.frombuffer(raw[header_len:], "<f4").astype(">f4").tobytes()
    g2 = read_ply(io.BytesIO(head + body))
    assert g2.count == 128
    np.testing.assert_array_equal(g2.pos, g.pos)
    np.testing.assert_array_equal(g2.sh_rest, g.sh_rest)
    np.testing.assert_array_equal(g2.rot, g.rot)


def test_ply_ascii_roundtrip_and_bad_lines():
    from wgpu_3dgs_viewer_app_tpu.data import PlyReadStats
    from wgpu_3dgs_viewer_app_tpu.data.gaussian import PLY_PROPERTIES

    g = make_random_scene(40, seed=10)
    pods = g.to_pod_records()
    lines = [b"ply\n", b"format ascii 1.0\n", b"element vertex 42\n"]
    lines += [f"property float {n}\n".encode() for n in PLY_PROPERTIES]
    lines.append(b"end_header\n")
    rows = [
        b" ".join(repr(float(pods[i][n])).encode() for n in PLY_PROPERTIES) + b"\n"
        for i in range(40)
    ]
    # Inject one short line and one non-numeric line (both must be skipped).
    rows.insert(10, b"1.0 2.0 3.0\n")
    rows.insert(25, b" ".join([b"xyz"] * 62) + b"\n")
    stats = PlyReadStats()
    g2 = read_ply(io.BytesIO(b"".join(lines + rows)), stats)
    assert g2.count == 40
    assert stats.skipped == 2
    np.testing.assert_allclose(g2.pos, g.pos, rtol=1e-6)


def test_streaming_loader_finishes_with_skipped_records():
    from wgpu_3dgs_viewer_app_tpu.app.loader import StreamingLoader

    g = make_random_scene(500, seed=11)
    raw = bytearray(_ply_bytes(g))
    header_len = raw.index(b"end_header\n") + len(b"end_header\n")
    rec_size = 62 * 4
    start = header_len + 250 * rec_size
    raw[start:start + rec_size] = np.full(62, np.inf, "<f4").tobytes()
    loader = StreamingLoader(io.BytesIO(bytes(raw)), chunk_size=100)
    import time

    total = 0
    for _ in range(200):
        total += loader.drain(budget_s=0.5)
        if loader.finished:
            break
        time.sleep(0.01)  # frame pacing: give the parser thread a slot
    assert loader.finished and loader.error is None
    assert total == 499
    assert loader.stats.skipped == 1


def test_committed_fixture_ply_parses_and_is_trained_like():
    """The committed Inria-format fixture (tests/fixtures/; generated by scripts/gen_fixture_ply.py because this
    environment has no network egress for a real trained capture) must
    parse through the production loader and show trained-model statistics:
    anisotropic log-scales, bimodal opacity, SH band-energy decay."""
    import os

    from wgpu_3dgs_viewer_app_tpu.data.ply import PlyReadStats

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "trained_like_100k.ply")
    with open(path, "rb") as f:
        header = read_ply_header(f)
    assert header.count == 100_000
    assert header.fmt == "binary_little_endian"

    stats = PlyReadStats()
    g = read_ply(path, stats)
    assert g.count == 100_000 and stats.skipped == 0
    assert np.isfinite(g.pos).all() and np.isfinite(g.sh_rest).all()

    # Trained-like statistics (coarse gates, not distribution tests):
    # squashed minor axis — max/min linear scale ratio typically >> 1.
    lin = np.exp(g.scale)
    ratio = lin.max(1) / np.maximum(lin.min(1), 1e-12)
    assert np.median(ratio) > 2.0
    # Bimodal opacity: both near-opaque and translucent modes populated.
    op = 1.0 / (1.0 + np.exp(-g.opacity))
    assert (op > 0.8).mean() > 0.2 and (op < 0.3).mean() > 0.05
    # SH band energy decays by degree.
    e1 = float((g.sh_rest[:, 0:3] ** 2).mean())
    e3 = float((g.sh_rest[:, 8:15] ** 2).mean())
    assert e1 > e3

    # A record PREFIX is a representative crop (the file is row-shuffled):
    # the golden scene (first 20k) must span the whole scene extent.
    with open(path, "rb") as f:
        h = read_ply_header(f)
        first = next(read_ply_chunks(f, h, chunk_size=20_000))
    assert first.count == 20_000
    span_crop = first.pos.max(0) - first.pos.min(0)
    span_full = g.pos.max(0) - g.pos.min(0)
    assert (span_crop > 0.8 * span_full).all()
