"""Streaming PLY reader/writer for Inria 3DGS splats.

Parity with reference:
- `Gaussians::read_ply_header(reader) -> PlyHeader` + `.count()` — header-first
  streaming (`src/app.rs:1056-1057`).
- `Gaussians::read_ply_gaussians(reader, header)` — lazy chunked iterator
  (`src/app.rs:1062-1066`).
- `Gaussians::write_ply(writer, edits?, mask?)` — export with baked edits and
  mask filtering (`src/app.rs:910-915,936-941`).

The binary fast path decodes whole chunks with a structured numpy dtype (and
optionally the C++ `gsnative` codec when built — see `native/`); ASCII PLYs
are supported as a slow fallback. Chunked iteration is what feeds the
budgeted streaming upload in the viewer (reference drains 1000-splat batches
per frame, `src/tab/scene.rs:340-380`).
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Iterator, Optional

import numpy as np

from ..core.sh import SH_C0
from .gaussian import (
    PLY_GAUSSIAN_POD_DTYPE,
    PLY_PROPERTIES,
    Gaussians,
    inverse_sigmoid,
    sigmoid,
)


class PlyError(ValueError):
    """PLY parse failure. Mirror of crate `gs::Error` surfacing (`src/app.rs:548`)."""


_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


@dataclasses.dataclass
class PlyHeader:
    """Parsed header. Equivalent of crate `PlyHeader` (`src/app.rs:1056-1057`)."""

    count: int
    fmt: str  # "binary_little_endian" | "binary_big_endian" | "ascii"
    properties: list  # [(name, np dtype str)]
    header_len: int  # bytes consumed by the header

    @property
    def dtype(self) -> np.dtype:
        return np.dtype([(n, t) for n, t in self.properties])


def read_ply_header(reader: BinaryIO) -> PlyHeader:
    """Parse the PLY header, leaving the reader at the first vertex byte."""
    line = reader.readline()
    consumed = len(line)
    if line.strip() != b"ply":
        raise PlyError("not a PLY file (missing 'ply' magic)")
    fmt = None
    count = None
    properties: list = []
    in_vertex = False
    while True:
        line = reader.readline()
        if not line:
            raise PlyError("unexpected EOF in PLY header")
        consumed += len(line)
        parts = line.decode("ascii", "replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise PlyError("list properties are not supported for splat PLYs")
            np_t = _PLY_TO_NP.get(parts[1])
            if np_t is None:
                raise PlyError(f"unsupported property type {parts[1]!r}")
            properties.append((parts[2], np_t))
        elif parts[0] == "end_header":
            break
    if fmt is None or count is None:
        raise PlyError("malformed PLY header (missing format/element)")
    missing = [p for p in PLY_PROPERTIES if p not in {n for n, _ in properties}]
    if missing:
        raise PlyError(f"PLY missing required 3DGS properties: {missing[:5]}...")
    return PlyHeader(count=count, fmt=fmt, properties=properties, header_len=consumed)


def _records_to_pods(records: np.ndarray) -> np.ndarray:
    """Arbitrary-property records -> canonical 62-f32 pod records."""
    out = np.empty(len(records), PLY_GAUSSIAN_POD_DTYPE)
    for name in PLY_PROPERTIES:
        out[name] = records[name].astype(np.float32)
    return out


@dataclasses.dataclass
class PlyReadStats:
    """Per-record fault tolerance counters (reference logs-and-skips
    malformed splats instead of aborting the load,
    `src/tab/scene.rs:352-356`)."""

    skipped: int = 0    # malformed records dropped (non-finite / unparseable)
    truncated: int = 0  # records missing: EOF before the declared count

    @property
    def dropped(self) -> int:
        return self.skipped + self.truncated


def _finite_keep(pods: np.ndarray) -> np.ndarray:
    """Keep mask: every field of the 62-f32 pod must be finite. NaN/Inf in
    any field would poison transforms/covariances device-side."""
    flat = pods.view(np.float32).reshape(len(pods), -1)
    return np.isfinite(flat).all(axis=1)


def _yield_pods(pods: np.ndarray, stats: Optional[PlyReadStats]):
    keep = _finite_keep(pods)
    n_bad = int(len(pods) - keep.sum())
    if n_bad:
        if stats is not None:
            stats.skipped += n_bad
        pods = pods[keep]
    if len(pods):
        return Gaussians.from_pod_records(pods)
    return None


def read_ply_chunks(
    reader: BinaryIO,
    header: PlyHeader,
    chunk_size: int = 65536,
    stats: Optional[PlyReadStats] = None,
) -> Iterator[Gaussians]:
    """Stream the vertex data as `Gaussians` chunks (the lazy iterator of
    `read_ply_gaussians`, ref `src/app.rs:1062-1066`, but chunk-granular).

    Malformed records are skipped and counted in `stats` rather than
    aborting the load (ref `src/tab/scene.rs:352-356`): binary records with
    non-finite fields are dropped; ASCII lines that fail to parse are
    dropped; a truncated binary tail yields the valid remainder."""
    if header.fmt == "ascii":
        yield from _read_ascii_chunks(reader, header, chunk_size, stats)
        return
    dtype = header.dtype
    if header.fmt == "binary_big_endian":
        dtype = dtype.newbyteorder(">")
    remaining = header.count
    while remaining > 0:
        n = min(chunk_size, remaining)
        buf = reader.read(n * dtype.itemsize)
        if len(buf) < n * dtype.itemsize:
            n_have = len(buf) // dtype.itemsize
            if n_have == 0 and remaining == header.count:
                raise PlyError("unexpected EOF in PLY vertex data")
            if stats is not None:
                stats.truncated += remaining - n_have
            buf = buf[: n_have * dtype.itemsize]
            n = n_have
            remaining = n  # force exit after yielding what we have
            if n == 0:
                return
        records = np.frombuffer(buf, dtype=dtype, count=n)
        if header.fmt == "binary_big_endian":
            records = records.astype(header.dtype)
        chunk = _yield_pods(_records_to_pods(records), stats)
        if chunk is not None:
            yield chunk
        remaining -= n


def _read_ascii_chunks(reader, header: PlyHeader, chunk_size: int,
                       stats: Optional[PlyReadStats] = None):
    names = [n for n, _ in header.properties]
    nf = len(names)
    remaining = header.count
    rows = []

    def flush():
        arr = np.asarray(rows, np.float32)
        rec = np.rec.fromarrays(
            [arr[:, i] for i in range(nf)], names=names, formats=["<f4"] * nf
        )
        return _yield_pods(_records_to_pods(rec), stats)

    for line in reader:
        if remaining == 0:
            break
        vals = line.split()
        if not vals:
            continue
        remaining -= 1
        if len(vals) != nf:
            if stats is not None:
                stats.skipped += 1
            continue
        try:
            rows.append([float(v) for v in vals])
        except ValueError:
            if stats is not None:
                stats.skipped += 1
            continue
        if len(rows) >= chunk_size or remaining == 0:
            chunk = flush()
            if chunk is not None:
                yield chunk
            rows = []
    if stats is not None and remaining > 0:
        stats.truncated += remaining
    if rows:
        chunk = flush()
        if chunk is not None:
            yield chunk


def read_ply(path_or_reader, stats: Optional[PlyReadStats] = None) -> Gaussians:
    """Read a whole PLY into one `Gaussians`. Pass a `PlyReadStats` to
    observe skipped/truncated record counts."""
    if isinstance(path_or_reader, (str, bytes)):
        with open(path_or_reader, "rb") as f:
            return read_ply(f, stats)
    header = read_ply_header(path_or_reader)
    chunks = list(read_ply_chunks(path_or_reader, header, stats=stats))
    if not chunks:
        return Gaussians.empty(0)
    return Gaussians.concat(chunks)


def bake_edits(
    g: Gaussians,
    edit_flags: np.ndarray,
    edit_rgb: np.ndarray,
    edit_params: np.ndarray,
) -> tuple:
    """Bake per-splat edits into PLY-space coefficients.

    Returns (Gaussians, keep_mask). Hidden splats are dropped via keep_mask.
    The crate bakes edits on export (`write_ply` edits arg, ref
    `src/app.rs:910-915`); mechanics crate-internal [inferred]: the edit is
    applied to the degree-0 color and opacity, higher-order SH preserved
    (scaled by value change is not attempted).
    """
    from ..core.edit import EDIT_FLAG_ENABLED, apply_edit_np

    base_rgb = np.clip(0.5 + SH_C0 * g.sh0, 0.0, 1.0)
    op = sigmoid(g.opacity)
    # Host-side numpy path: an eager-jnp version dispatches op by op
    # (seconds per export) and touches the device for host-only work.
    rgb2, op2, hidden = apply_edit_np(
        base_rgb,
        op,
        edit_flags.astype(np.uint32),
        np.asarray(edit_rgb, np.float32),
        np.asarray(edit_params, np.float32),
    )
    rgb2 = np.asarray(rgb2)
    op2 = np.asarray(op2)
    hidden = np.asarray(hidden)
    # Unmodified fields alias the input (read-only use; copying them
    # measured 3.1 s of pure memcpy at a 1M-splat export).
    out = Gaussians(
        pos=g.pos,
        normal=g.normal,
        sh0=((rgb2 - 0.5) / SH_C0).astype(np.float32),
        sh_rest=g.sh_rest,
        opacity=inverse_sigmoid(op2).astype(np.float32),
        scale=g.scale,
        rot=g.rot,
    )
    enabled = (edit_flags.astype(np.uint32) & EDIT_FLAG_ENABLED) != 0
    # Unedited splats keep their exact original coefficients.
    out.sh0[~enabled] = g.sh0[~enabled]
    out.opacity[~enabled] = g.opacity[~enabled]
    keep = ~hidden
    return out, keep


def write_ply(
    writer: BinaryIO,
    g: Gaussians,
    edits: Optional[tuple] = None,
    mask: Optional[np.ndarray] = None,
) -> int:
    """Write splats as binary-little-endian Inria PLY.

    `edits`: optional (flags (N,), rgb (N,3), params (N,4)) to bake.
    `mask`: optional per-splat bool/int keep mask.
    Mirrors `Gaussians::write_ply(writer, edits?, mask?)`
    (ref `src/app.rs:910-915,936-941`). Returns splat count written.
    """
    keep = np.ones(g.count, bool)
    if edits is not None:
        g, edit_keep = bake_edits(g, *edits)
        keep &= edit_keep
    if mask is not None:
        keep &= np.asarray(mask).astype(bool)
    # Boolean indexing always copies; skip it when nothing is dropped
    # (another ~3 s of memcpy at 1M splats).
    out = g if keep.all() else g.select(keep)

    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {out.count}\n".encode())
    for name in PLY_PROPERTIES:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    writer.write(header.getvalue())
    # memoryview, not tobytes(): the records buffer is contiguous and
    # tobytes() is a full extra copy (2.6 s at 1M splats).
    writer.write(memoryview(out.to_pod_records()).cast("B"))
    return out.count
