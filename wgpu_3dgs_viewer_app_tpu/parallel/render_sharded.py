"""Multi-chip sharded rendering over a `jax.sharding.Mesh`.

The reference is a single-GPU app (SURVEY §2.3) — multi-device scaling is a
*new* capability, not a port. Design ("slab-owner routing"; a full
`all_gather` would move ~44 B x N per device per frame regardless of
visibility):

- **Splat axis = data parallel.** Pod arrays are sharded over the mesh's
  `splats` axis; preprocess AND tile enumeration AND a first depth-key sort
  all run on local shards only (zero communication). The big sort — the
  frame's dominant cost single-chip — is thereby distributed.
- **Tile axis = output parallel.** The screen is cut into horizontal slabs
  of whole tile rows, one slab per device. Because entries are locally
  sorted by the (tile | depth | alpha) key, each slab's entries form ONE
  contiguous run per source device, found with a searchsorted against the
  slab boundary keys. A single `ragged_all_to_all` then routes exactly the
  LIVE entries to their slab owners — sentinel (culled) entries sort past
  the last boundary and are never transmitted, so interconnect volume is
  proportional to live on-screen entries, not N.
- **Owner side.** Each device merges its n_dev received sorted runs (one
  local sort over its ~E_live/n_dev slice), derives per-tile ranges, and
  composites only its slab. The frame ends image-sharded over devices.

Entry payloads survive routing unchanged: the packed mean is relative to
the entry's own tile origin (ops/binning.py), which is slab-invariant.

This mirrors sequence-parallel style sharding of the splat axis with
tile-fragment ownership per chip (SURVEY §5 "long-context" row).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.compression import Compressions
from ..ops.backend import render_impl
from ..ops.binning import (
    SortedEntries,
    TileConfig,
    enumerate_entries_from_pre,
    sort_entries,
)
from ..ops.composite import composite_tiles_v2, over_background
from ..ops.preprocess import preprocess

# Python int, not jnp.uint32(...): a module-level device scalar would
# initialize the default JAX backend AT IMPORT — before callers (e.g.
# dryrun_multichip) can pin the platform/device. All uses are inside jnp
# ops that coerce it with an explicit dtype.
SENTINEL = 0xFFFFFFFF

# Last sharded render's routing stats, for UI observability (the app
# server's /state payload reports it — a skewed scene whose slab routing
# overflowed capacity_factor is otherwise silent). The overflow value is
# kept as the DEVICE array to avoid a host sync on the render path;
# `last_stats()` materializes it on demand.
_LAST = {"overflow": None, "n_devices": 0}


def last_stats() -> dict | None:
    """{"overflow": int, "n_devices": int} of the most recent sharded
    render in this process, or None if none has run."""
    if _LAST["overflow"] is None:
        return None
    return {"overflow": int(jnp.max(_LAST["overflow"])),
            "n_devices": _LAST["n_devices"]}


def make_mesh(devices=None, axis: str = "splats") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def mesh_impl(mesh: Mesh) -> tuple:
    """(render implementation, ragged transport) for the mesh's platform.

    XLA:CPU has no ragged-all-to-all thunk, so the CPU mesh (tests, dryrun)
    routes with the equal-split `all_to_all`."""
    impl = render_impl(mesh.devices.ravel()[0].platform)
    return impl, RAGGED_TRANSPORT[impl]


# Whether each implementation routes with `ragged_all_to_all`.
RAGGED_TRANSPORT = {"gpu": True, "cpu": False}


def slab_config(cfg: TileConfig, n_devices: int) -> tuple:
    """Split the screen into `n_devices` slabs of whole tile rows.

    Returns (slab_cfg, slab_height, padded_height). The slab cfg is only
    used for compositing geometry; sort keys stay in the GLOBAL cfg's
    layout end to end.
    """
    rows_total = cfg.tiles_y
    rows_per = -(-rows_total // n_devices)
    slab_h = rows_per * cfg.tile
    padded_h = slab_h * n_devices
    slab_cfg = TileConfig(cfg.width, slab_h, tile=cfg.tile, max_dup=cfg.max_dup)
    return slab_cfg, slab_h, padded_h


def shard_pod(pod: dict, mesh: Mesh, axis: str = "splats") -> dict:
    """Place pod arrays sharded over the splat-row axis (pad rows to a
    device multiple)."""
    n_dev = mesh.shape[axis]
    out = {}
    for k, v in pod.items():
        rows = v.shape[-2]
        pad = (-rows) % n_dev
        if pad:
            pad_shape = v.shape[:-2] + (pad, v.shape[-1])
            v = jnp.concatenate([v, jnp.zeros(pad_shape, v.dtype)], axis=-2)
        out[k] = jax.device_put(v, NamedSharding(mesh, _pod_spec(v, axis)))
    return out


def _pod_spec(v, axis):
    """Rows-layout pod arrays carry the splat axis as (R, 128): shard the
    row dim (-2); the 128-lane dim stays whole on every device."""
    return P(*([None] * (v.ndim - 2)), axis, None)


def _route_entries(planes, axis: str, n_dev: int, boundaries, e_cap: int,
                   ragged: bool):
    """Route locally-sorted entry planes to their slab owners.

    planes: (E_local, 4) u32, sorted ascending by column 0 (the key).
    boundaries: (n_dev,) u32 — first key of each slab (slab o owns keys in
    [boundaries[o], boundaries[o+1]), the last implicitly ending before the
    sentinel bucket).
    Returns (routed, dropped): routed is (E_cap, 4) u32 on each device —
    that device's slab entries as n_dev concatenated sorted runs,
    sentinel-filled beyond the live total. dropped is a replicated i32
    scalar: the GLOBAL number of live entries truncated by the static
    capacity clamp this frame (0 in normal operation; >0 means the scene
    skew exceeded capacity_factor and splats are missing — raise it).

    Transports (`ragged`):
    - True: one tiny all_gather of the (n_dev,) send-size rows plus
      one `ragged_all_to_all` carrying exactly the live entries —
      interconnect volume ∝ live on-screen entries, not N.
    - False (CPU fallback — XLA:CPU has no ragged-all-to-all thunk): one
      equal-split `all_to_all` of per-pair runs padded to e_cap/n_dev.
      Same routing metadata; transport volume is the static capacity.
    """
    keys = planes[:, 0]
    upper = jnp.concatenate(
        [boundaries[1:], jnp.asarray([SENTINEL], jnp.uint32)]
    )
    starts = jnp.searchsorted(keys, boundaries, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(keys, upper, side="left").astype(jnp.int32)
    send = ends - starts  # (n_dev,) live entries bound for each owner

    if not ragged:
        # Rounded UP to a 128 multiple so routed rows always reshape to
        # (rows, 128) even for non-power-of-two device counts.
        cap_pair = -(-e_cap // (n_dev * 128)) * 128
        e_local = planes.shape[0]
        # Pad so a dynamic_slice starting at any live offset stays in range.
        planes_p = jnp.concatenate(
            [planes, jnp.full((cap_pair, planes.shape[1]), SENTINEL, jnp.uint32)]
        )
        idx = jax.lax.broadcasted_iota(jnp.int32, (cap_pair, 1), 0)
        runs = []
        for j in range(n_dev):
            run = jax.lax.dynamic_slice(
                planes_p,
                (jnp.minimum(starts[j], e_local), 0),
                (cap_pair, planes.shape[1]),
            )
            runs.append(jnp.where(idx < send[j], run, jnp.uint32(SENTINEL)))
        stacked = jnp.stack(runs, axis=0)  # (n_dev, cap_pair, 4)
        routed = jax.lax.all_to_all(stacked, axis, 0, 0, tiled=False)
        dropped = jax.lax.psum(
            jnp.sum(jnp.maximum(send - cap_pair, 0)), axis
        )
        return routed.reshape(-1, planes.shape[1]), dropped

    # Full (n_dev, n_dev) send matrix S[i, j]: tiny, exchanged once.
    s_mat = jax.lax.all_gather(send, axis)  # (n_dev src, n_dev dst)
    me = jax.lax.axis_index(axis)
    col = s_mat[:, me]  # sizes every source sends to ME
    recv_offsets_all = jnp.cumsum(
        jnp.concatenate([jnp.zeros((1, n_dev), jnp.int32), s_mat[:-1]]), axis=0
    )  # recv_offsets_all[i, j] = where source i's run starts on device j
    out_off = recv_offsets_all[me]  # (n_dev,) my run's start on each owner
    # Static receive capacity: clamp (deterministically, later sources drop
    # first) so offsets never exceed the buffer.
    out_off_c = jnp.minimum(out_off, e_cap)
    send_c = jnp.minimum(send, e_cap - out_off_c)
    recv_off_me = recv_offsets_all[:, me]
    recv_c = jnp.minimum(
        col, jnp.maximum(e_cap - jnp.minimum(recv_off_me, e_cap), 0)
    )
    # Global overflow: s_mat is replicated post-gather, so every device can
    # count ALL pairs' clamp losses without another collective.
    off_c_all = jnp.minimum(recv_offsets_all, e_cap)
    sz_c_all = jnp.minimum(s_mat, e_cap - off_c_all)
    dropped = jnp.sum(s_mat - sz_c_all)
    out_buf = jnp.full((e_cap, planes.shape[1]), SENTINEL, jnp.uint32)
    routed = jax.lax.ragged_all_to_all(
        planes,
        out_buf,
        input_offsets=starts,
        send_sizes=send_c,
        output_offsets=out_off_c,
        recv_sizes=recv_c,
        axis_name=axis,
    )
    return routed, dropped


def _slab_entries(routed, cfg: TileConfig, slab_cfg: TileConfig,
                  slab_tile0) -> SortedEntries:
    """Owner-side: merge received runs (one local sort), derive the slab's
    per-tile ranges from the GLOBAL-layout keys, and package the planes in
    the compositor's layout."""
    sk, s1, s2, s3 = jax.lax.sort(
        (routed[:, 0], routed[:, 1], routed[:, 2], routed[:, 3]), num_keys=1,
        is_stable=False,
    )
    shift = jnp.uint32(cfg._tile_shift)
    # Clamp to the real tile range: when tile rows don't divide evenly the
    # trailing slabs sit past the screen (tile ids that would overflow the
    # key's tile field if shifted unclamped); their ranges come out empty.
    bounds = jnp.minimum(
        slab_tile0.astype(jnp.uint32)
        + jnp.arange(slab_cfg.n_tiles + 1, dtype=jnp.uint32),
        jnp.uint32(cfg.n_tiles),
    ) << shift
    edges = jnp.searchsorted(sk, bounds, side="left").astype(jnp.int32)
    starts = edges[:-1]
    counts = edges[1:] - edges[:-1]
    n_valid = jnp.sum(counts)
    e = sk.shape[0]
    rows = e // 128
    planes = jnp.stack(
        [a.reshape(rows, 128) for a in (sk, s1, s2, s3)], axis=1
    )
    return SortedEntries(
        planes=planes, tile_starts=starts, tile_counts=counts, n_valid=n_valid
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "comp", "cfg", "sh_degree", "display_mode",
        "impl", "capacity_factor", "ragged",
    ),
)
def render_frame_sharded(
    pod: dict,
    mesh: Mesh,
    axis: str,
    comp: Compressions,
    cfg: TileConfig,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    model: jnp.ndarray,
    background: jnp.ndarray,
    sh_degree: int = 3,
    display_mode: int = 0,
    impl: str = "cpu",
    capacity_factor: float = 2.0,
    ragged: bool = False,
):
    """Sharded frame -> ((padded_H, W, 3), (n_dev,) overflow); image rows
    beyond cfg.height are blank.

    `capacity_factor` sizes each owner's static receive buffer as
    factor x E_local (mean load is E_live/n_dev; 2x mean absorbs realistic
    slab skew; overflow drops later sources' farthest entries
    deterministically). The overflow output counts the GLOBAL live entries
    truncated by that clamp this frame (replicated — every element equal);
    nonzero means splats are missing from the image and capacity_factor
    should be raised."""
    n_dev = mesh.shape[axis]
    slab_cfg, slab_h, padded_h = slab_config(cfg, n_dev)
    rows_per_slab = slab_cfg.tiles_y

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            {k: _pod_spec(v, axis) for k, v in pod.items()},
            P(), P(), P(), P(),
        ),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def step(pod_local, view_, proj_, model_, bg_):
        # 1) data-parallel preprocess on the local splat shard (no comm).
        pre_local = preprocess(
            pod_local, comp, view_, proj_, model_, cfg.width, cfg.height,
            sh_degree=sh_degree, display_mode=display_mode,
        )
        # 2) local tile enumeration in the GLOBAL key layout + local sort
        #    (the expensive sort is distributed across devices).
        keys, p1, p2, p3 = enumerate_entries_from_pre(pre_local, cfg)
        sk, s1, s2, s3 = sort_entries(keys, p1, p2, p3)
        planes = jnp.stack([sk, s1, s2, s3], axis=1)  # (E_local', 4)

        # 3) slab-owner routing: one ragged_all_to_all of live entries only.
        boundaries = jnp.minimum(
            jnp.arange(n_dev, dtype=jnp.uint32)
            * jnp.uint32(rows_per_slab * cfg.tiles_x),
            jnp.uint32(cfg.n_tiles),
        ) << jnp.uint32(cfg._tile_shift)
        e_cap = -(-int(capacity_factor * keys.shape[0]) // 128) * 128
        routed, dropped = _route_entries(planes, axis, n_dev, boundaries,
                                         e_cap, ragged)

        # 4) owner-side merge + per-tile ranges + slab composite.
        did = jax.lax.axis_index(axis)
        slab_tile0 = did.astype(jnp.int32) * (rows_per_slab * cfg.tiles_x)
        entries = _slab_entries(routed, cfg, slab_cfg, slab_tile0)
        img = composite_tiles_v2(entries, slab_cfg, display_mode != 0, impl)
        return over_background(img, bg_), jnp.reshape(dropped, (1,))

    return step(pod, view, proj, model, jnp.asarray(background, jnp.float32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis", "comp", "cfg", "sh_degree", "display_mode",
        "impl", "capacity_factor", "ragged",
    ),
)
def render_frame_sharded_multi(
    pods: tuple,
    mesh: Mesh,
    axis: str,
    comp: Compressions,
    cfg: TileConfig,
    view: jnp.ndarray,
    proj: jnp.ndarray,
    models: jnp.ndarray,
    ranks: jnp.ndarray,
    background: jnp.ndarray,
    sh_degree: int = 3,
    display_mode: int = 0,
    impl: str = "cpu",
    capacity_factor: float = 2.0,
    ragged: bool = False,
):
    """Sharded MERGED multi-model frame: every model's entries carry a model
    rank in the sort key (viewer._render_merged semantics — one sort + one
    compositing pass reproduce the reference's back-to-front per-model
    draws, `src/tab/scene.rs:2299-2315`) and the combined entry stream goes
    through the same slab-owner routing as the single-model path.

    pods: tuple of pod dicts, each sharded over `axis`. models: (M, 4, 4)
    transforms. ranks: (M,) u32 — nearest model must be rank 0.
    Returns ((padded_H, W, 3), (n_dev,) overflow) like render_frame_sharded.
    """
    import dataclasses as _dc

    n_dev = mesh.shape[axis]
    n_models = len(pods)
    mbits = max(1, (n_models - 1).bit_length())
    cfg_m = _dc.replace(cfg, model_bits=mbits)
    slab_cfg, slab_h, padded_h = slab_config(cfg, n_dev)
    rows_per_slab = slab_cfg.tiles_y

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple({k: _pod_spec(v, axis) for k, v in pod.items()} for pod in pods),
            P(), P(), P(), P(), P(),
        ),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def step(pods_local, view_, proj_, models_, ranks_, bg_):
        parts = []
        for i, pod_local in enumerate(pods_local):
            pre = preprocess(
                pod_local, comp, view_, proj_, models_[i], cfg.width,
                cfg.height, sh_degree=sh_degree, display_mode=display_mode,
            )
            parts.append(enumerate_entries_from_pre(pre, cfg_m, model_rank=ranks_[i]))
        keys, p1, p2, p3 = (
            jnp.concatenate([p[j] for p in parts]) for j in range(4)
        )
        sk, s1, s2, s3 = sort_entries(keys, p1, p2, p3)
        planes = jnp.stack([sk, s1, s2, s3], axis=1)
        boundaries = jnp.minimum(
            jnp.arange(n_dev, dtype=jnp.uint32)
            * jnp.uint32(rows_per_slab * cfg_m.tiles_x),
            jnp.uint32(cfg_m.n_tiles),
        ) << jnp.uint32(cfg_m._tile_shift)
        e_cap = -(-int(capacity_factor * keys.shape[0]) // 128) * 128
        routed, dropped = _route_entries(planes, axis, n_dev, boundaries,
                                         e_cap, ragged)
        did = jax.lax.axis_index(axis)
        slab_tile0 = did.astype(jnp.int32) * (rows_per_slab * cfg_m.tiles_x)
        entries = _slab_entries(routed, cfg_m, slab_cfg, slab_tile0)
        img = composite_tiles_v2(entries, slab_cfg, display_mode != 0, impl)
        return over_background(img, bg_), jnp.reshape(dropped, (1,))

    return step(pods, view, proj, models, ranks,
                jnp.asarray(background, jnp.float32))


def render_sharded(
    pod: dict,
    mesh: Mesh,
    comp: Compressions,
    cfg: TileConfig,
    view,
    proj,
    model=None,
    background=(0.0, 0.0, 0.0),
    sh_degree: int = 3,
    display_mode: int = 0,
    axis: str = "splats",
    capacity_factor: float = 2.0,
    ragged: bool | None = None,
    return_stats: bool = False,
):
    """Convenience wrapper; returns (H, W, 3) cropped to the real viewport.
    With `return_stats`, returns (img, {"overflow": int}) — overflow is the
    count of live entries dropped by the routing capacity clamp (0 unless
    the slab skew exceeded capacity_factor)."""
    if model is None:
        model = jnp.eye(4)
    impl, default_ragged = mesh_impl(mesh)
    if ragged is None:
        ragged = default_ragged
    img, overflow = render_frame_sharded(
        pod,
        mesh,
        axis,
        comp,
        cfg,
        jnp.asarray(view),
        jnp.asarray(proj),
        jnp.asarray(model),
        jnp.asarray(background, jnp.float32),
        sh_degree=sh_degree,
        display_mode=display_mode,
        impl=impl,
        capacity_factor=capacity_factor,
        ragged=ragged,
    )
    img = img[: cfg.height]
    _LAST["overflow"] = overflow
    _LAST["n_devices"] = mesh.devices.size
    if return_stats:
        return img, {"overflow": int(overflow.max())}
    return img
