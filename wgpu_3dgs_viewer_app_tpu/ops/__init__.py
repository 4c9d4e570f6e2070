from .backend import render_impl
from .binning import (
    EntryPlanes,
    SortedEntries,
    TileConfig,
    TileLists,
    build_entry_planes,
    build_sorted_entries,
    build_tile_lists,
    enumerate_entries_from_pre,
    sort_and_range_entries,
    sort_entries,
)
from .composite import (
    composite_tiles_gpu,
    composite_tiles_jnp,
    composite_tiles_jnp_v2,
    composite_tiles_v2,
    over_background,
)
from .preprocess import PreprocessOut, preprocess
from .rasterize_ref import rasterize_reference

__all__ = [
    "EntryPlanes",
    "render_impl",
    "sort_entries",
    "enumerate_entries_from_pre",
    "sort_and_range_entries",
    "SortedEntries",
    "build_sorted_entries",
    "composite_tiles_gpu",
    "composite_tiles_jnp_v2",
    "composite_tiles_v2",
    "TileConfig",
    "TileLists",
    "build_entry_planes",
    "build_tile_lists",
    "composite_tiles_jnp",
    "over_background",
    "PreprocessOut",
    "preprocess",
    "rasterize_reference",
]
