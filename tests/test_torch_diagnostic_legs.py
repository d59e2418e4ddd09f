"""The committed reference legs that the accuracy diagnostics read
(tpu_vo_torch/data/reference_trajectories.json, `diag_*`): the parity
matrix's two 320x240 legs of 48 frames hash as the port renders them, and
every diagnostic leg's record names its scene and degradation as
tools/reference_band makes it."""

import pytest

from tpu_vo_torch.tools import reference_band
from tpu_vo_torch.utils import synthetic
from _torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("leg", ["diag_pan_320x240", "diag_corridor_320x240"])
def test_parity_matrix_legs_hash_as_rendered(leg):
    rec = reference_band.load()[leg]
    assert (rec["scene"], rec["T"], rec["W"], rec["H"], rec["seed"]) == reference_band.LEGS[leg]
    frames = synthetic.render(*reference_band.LEGS[leg])[0]
    assert synthetic.frames_sha256(frames) == rec["frames_sha256"]


def test_diagnostic_legs_are_recorded():
    legs = reference_band.load()
    names = [n for n in reference_band.LEGS if n.startswith("diag_")]
    assert len(names) == 7 and set(names) <= set(legs)
    for n in names:
        label, kwargs = reference_band.degradation(n)
        assert legs[n].get("nuisance") == label
        assert (legs[n]["scene"], legs[n]["T"], legs[n]["W"], legs[n]["H"],
                legs[n]["seed"]) == reference_band.LEGS[n]
        if n.startswith("diag_pan_only_"):
            assert kwargs["which"] == (label[len("only_"):],)
            assert legs[n]["nuisance_seed"] == synthetic.NUISANCE_SEED
    sets = reference_band.load_diagnostics()
    assert set(sets) == {reference_band.diag_key(W, H, n)
                         for W, H, n, _ in reference_band.DIAG_KEYPOINTS}
    assert all(len(s["keypoints"]) > 0.9 * s["n_features"] for s in sets.values())
