"""Generate the committed trained-like PLY fixture.

A real Inria-trained PLY excerpt cannot be fetched without network
access. The honest substitute is a COMMITTED, bit-stable Inria-format
binary PLY with trained-model statistics (surface-concentrated positions,
squashed-disc anisotropy, bimodal opacity, SH band decay — see
data/synthetic.make_inria_like_scene), generated once by this script and
checked in at tests/fixtures/trained_like_100k.ply.

What the committed artifact pins that in-memory synthesis cannot:
  * the loader tests parse a real on-disk binary PLY (header + 62-float
    records, ref `src/app.rs:1062-1066` record layout) instead of arrays;
  * the golden images render from a FIXED file, so editing synthetic.py
    can never silently move the fidelity anchor;
  * records are row-shuffled, so any record PREFIX is a representative
    scene crop (gen_golden.py streams the first 20k).

Regenerate (intentionally — goldens must be regenerated too):
    python scripts/gen_fixture_ply.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply")
N, SEED = 100_000, 11


def main() -> int:
    from wgpu_3dgs_viewer_app_tpu.data import make_inria_like_scene, write_ply

    g = make_inria_like_scene(N, seed=SEED)
    # Row-shuffle so any prefix of the file is a representative crop
    # (synthesis concatenates [ground | objects | background]).
    order = np.random.Generator(np.random.SFC64(SEED)).permutation(N)
    g = _reorder(g, order)
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "wb") as f:
        count = write_ply(f, g)
    digest = hashlib.sha256(open(FIXTURE, "rb").read()).hexdigest()
    print(f"wrote {FIXTURE}: {count} splats, "
          f"{os.path.getsize(FIXTURE) / 1e6:.1f} MB, sha256 {digest[:16]}…")
    return 0


def _reorder(g, order):
    import dataclasses

    return dataclasses.replace(
        g,
        pos=g.pos[order], normal=g.normal[order], sh0=g.sh0[order],
        sh_rest=g.sh_rest[order], opacity=g.opacity[order],
        scale=g.scale[order], rot=g.rot[order],
    )


if __name__ == "__main__":
    raise SystemExit(main())
