"""Configuration and state carried between tpu_vo and tpu_vo_torch.

The system has no learned weights; what crosses between the two packages
is configuration (frozen dataclasses with the same fields) and the
intermediate state of the pipeline, as numpy arrays. ORBFeatures.desc32
holds the uint32 lanes' bit pattern as int32 in the port; the numpy side
carries it as uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from tpu_vo_torch.configs import MatchConfig, ORBConfig, RansacConfig, VOConfig
from tpu_vo_torch.features.orb import ORBFeatures
from tpu_vo_torch.geometry.se3 import Pose

_NESTED = {"orb": ORBConfig, "match": MatchConfig, "ransac": RansacConfig}


def _fields(obj: Any) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return dict(obj)


def config_from_fields(fields: Mapping[str, Any]) -> VOConfig:
    """VOConfig from a mapping of its fields; the nested orb/match/ransac
    entries may be mappings or any dataclass with the same fields (such
    as tpu_vo's configs)."""
    kw = dict(fields)
    for name, cls in _NESTED.items():
        if name in kw and not isinstance(kw[name], cls):
            kw[name] = cls(**_fields(kw[name]))
    if kw.get("intrinsics_override") is not None:
        kw["intrinsics_override"] = tuple(kw["intrinsics_override"])
    return VOConfig(**kw)


def features_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> ORBFeatures:
    """ORBFeatures from a mapping of numpy arrays with its field names."""
    out = {}
    for name in ORBFeatures._fields:
        a = np.asarray(arrays[name])
        if name == "desc32":
            a = a.astype(np.uint32).view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return ORBFeatures(**out)


def pose_from_numpy(R: np.ndarray, t: np.ndarray, device=None) -> Pose:
    return Pose(torch.as_tensor(np.asarray(R, np.float32), device=device),
                torch.as_tensor(np.asarray(t, np.float32), device=device))


def to_numpy(x: Any) -> Any:
    """Tensors, NamedTuples of tensors and dicts of them -> numpy (a
    NamedTuple becomes a dict of its fields; desc32 becomes uint32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        d = {k: to_numpy(v) for k, v in zip(x._fields, x)}
        if "desc32" in d:
            d["desc32"] = d["desc32"].view(np.uint32)
        return d
    if isinstance(x, Mapping):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
