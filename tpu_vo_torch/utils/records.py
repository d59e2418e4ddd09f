"""Structured per-frame observability records (port of
tpu_vo/utils/records.py): the reference's debug prints, collected in
VOStepOutput and rendered in one place as the reference's text, JSON
lines or a CSV table.
"""

from __future__ import annotations

import json
from typing import Iterable, List

import numpy as np
import torch


def step_record(i: int, out) -> dict:
    """One frame's diagnostics as a plain dict (out: VOStepOutput slice)."""
    pos = np.asarray(torch.as_tensor(out.pose.t).cpu(), dtype=float)
    return {
        "frame": int(i),
        "keypoints": int(out.num_keypoints),
        "matches": int(out.num_matches),
        "inliers": int(out.num_inliers),
        "valid_points": int(out.num_valid_points),
        "pose_ok": bool(out.pose_ok),
        "scale": float(out.scale),
        "epipolar_residual": float(out.epipolar_residual),
        "position": [float(pos[0]), float(pos[1]), float(pos[2])],
    }


def format_reference_style(rec: dict) -> str:
    """Render a record with the reference's print formats."""
    lines = [
        f"Frame {rec['frame']}: Detected {rec['keypoints']} keypoints",
        (f"[MatchDebug] #matches={rec['matches']}"
         f"  inliers={rec['inliers']}  valid={rec['valid_points']}"
         f"  (units: Hamming bits)"),
        (f"[PoseUpdate] matches={rec['matches']}"
         f" pose_ok={int(rec['pose_ok'])} scale={rec['scale']:.1f}"),
        (f"Mean |x2^T F x1| over inliers: {rec['epipolar_residual']:.6g}"),
        (f"Position: [{rec['position'][0]:.6g}, {rec['position'][1]:.6g}, "
         f"{rec['position'][2]:.6g}]"),
    ]
    return "\n".join(lines)


def _index(x, i: int):
    """Entry i of every tensor in nested NamedTuples."""
    if isinstance(x, torch.Tensor):
        return x[i]
    return type(x)(*(_index(f, i) for f in x))


def sequence_records(outputs) -> List[dict]:
    """Records for stacked VOStepOutput (leading time axis)."""
    return [step_record(i, _index(outputs, i)) for i in range(len(outputs.num_matches))]


def write_jsonl(path: str, records: Iterable[dict]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def write_csv(path: str, records: List[dict]) -> None:
    if not records:
        return
    keys = [k for k in records[0] if k != "position"]
    with open(path, "w") as f:
        f.write(",".join(keys + ["x", "y", "z"]) + "\n")
        for r in records:
            row = [str(r[k]) for k in keys] + [str(v) for v in r["position"]]
            f.write(",".join(row) + "\n")
