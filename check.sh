#!/usr/bin/env bash
# Quality gate — the equivalent of the reference's check.sh
# (fmt/clippy/test/build, reference check.sh:5-11). CPU only.
set -euo pipefail
cd "$(dirname "$0")"

echo "== import check"
python -c "import wgpu_3dgs_viewer_app_tpu as m; print('version', m.__version__)"

echo "== native codec build"
python -m wgpu_3dgs_viewer_app_tpu.native.build || echo "(native build skipped)"

echo "== tests (CPU, 8-device virtual mesh)"
python -m pytest tests/ -q

echo "== graft entry compile check"
python - <<'PY'
import sys; sys.path.insert(0, '.')
import jax
jax.config.update('jax_platforms', 'cpu')
import __graft_entry__ as ge
fn, args = ge.entry()
out = jax.jit(fn)(*args)
print('entry ok', out.shape)
ge.dryrun_multichip(min(8, len(jax.devices())))
PY
echo "ALL CHECKS PASSED"
