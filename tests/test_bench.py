"""`bench.py` refuses to report a number without a GPU."""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def test_child_fails_without_gpu(capsys):
    bench.run_single("0")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is False and "no GPU" in out["error"]
    assert out["results"] == {}
