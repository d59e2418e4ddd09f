"""The port's configs equal tpu_vo's, and tpu_vo_torch imports neither
jax, tpu_vo, the repo's tools/, PIL nor (at import) cv2."""

import dataclasses
import subprocess
import sys

import pytest

import tpu_vo.configs as jc
import tpu_vo_torch.configs as tc
from tpu_vo_torch import interop

NAMES = ["ORBConfig", "MatchConfig", "RansacConfig", "VOConfig", "ViewerConfig"]


def _defaults(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_equal(name):
    a, b = getattr(jc, name), getattr(tc, name)
    da, db = _defaults(a), _defaults(b)
    assert [n for n, _ in da] == [n for n, _ in db]
    for (n, va), (_, vb) in zip(da, db):
        if dataclasses.is_dataclass(va):
            assert _defaults(type(va)) == _defaults(type(vb)), n
        else:
            assert va == vb, n


def test_derived_properties_equal():
    a = jc.VOConfig.reference_parity(640, 480, n_features=500)
    b = tc.VOConfig.reference_parity(640, 480, n_features=500)
    assert a.intrinsics == b.intrinsics
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.orb.harris_block_size, a.orb.harris_k, a.orb.half_patch) == \
        (b.orb.harris_block_size, b.orb.harris_k, b.orb.half_patch)


def test_config_from_fields_round_trip():
    a = jc.VOConfig(image_width=480, image_height=360,
                    orb=jc.ORBConfig(n_features=300, n_levels=3),
                    ransac=jc.RansacConfig(max_iters=64),
                    intrinsics_override=(500.0, 500.0, 240.0, 180.0))
    b = interop.config_from_fields({f.name: getattr(a, f.name)
                                    for f in dataclasses.fields(a)})
    assert isinstance(b, tc.VOConfig)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    c = interop.config_from_fields(dataclasses.asdict(a))
    assert c == b


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_vo", "tools", "cv2", "PIL"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import tpu_vo_torch
mods = [m.name for m in pkgutil.walk_packages(tpu_vo_torch.__path__, "tpu_vo_torch.")]
for m in mods:
    importlib.import_module(m)
five = importlib.import_module("tpu_vo_torch.estimation.five_point")
assert all(callable(getattr(five, h)) for h in AOS_HELPERS), AOS_HELPERS
assert not any(k.split(".")[0] in ("jax", "tpu_vo", "tools", "cv2", "PIL") for k in sys.modules)
print(" ".join(mods))
"""

# The modules of the patch-slots probe, which replace tools/ modules
PROBE_MODULES = ["tpu_vo_torch.ops.patch_probe", "tpu_vo_torch.tools.device_time",
                 "tpu_vo_torch.tools.patch_slots_probe"]
# The streaming path's modules, which replace tpu_vo modules that import jax
# (api, cli, io/trajectory_io) or sit in a package that does (io/)
STREAM_MODULES = ["tpu_vo_torch.api", "tpu_vo_torch.cli", "tpu_vo_torch.io.dataset",
                  "tpu_vo_torch.io.kitti", "tpu_vo_torch.io.trajectory_io",
                  "tpu_vo_torch.image.color", "tpu_vo_torch.utils.records",
                  "tpu_vo_torch.utils.metrics"]

# The accuracy path's modules; cv_reference and reference_band reach cv2
# only inside their functions
ACCURACY_MODULES = ["tpu_vo_torch.utils.synthetic", "tpu_vo_torch.utils.cv_reference",
                    "tpu_vo_torch.tools.reference_band", "tpu_vo_torch.tools.run_benchmarks",
                    "tpu_vo_torch.models.refinement", "tpu_vo_torch.parallel.sharding",
                    "tpu_vo_torch.geometry.triangulation", "tpu_vo_torch.estimation.five_point"]

# The ingest path's modules, which replace tpu_vo modules that import jax
# (io/loader, pipeline/runner) or sit in a package that does (io/)
INGEST_MODULES = ["tpu_vo_torch.io", "tpu_vo_torch.io.native_loader", "tpu_vo_torch.io.loader",
                  "tpu_vo_torch.pipeline.upload", "tpu_vo_torch.pipeline.runner",
                  "tpu_vo_torch.tools.io_bench"]


# The viewer's modules and the user tools, which replace tpu_vo modules that
# draw with PIL or import jax; cv2 only inside viz/gui's function
VIZ_MODULES = ["tpu_vo_torch.viz", "tpu_vo_torch.viz.raster", "tpu_vo_torch.viz.overlay",
               "tpu_vo_torch.viz.trajectory", "tpu_vo_torch.viz.epipolar", "tpu_vo_torch.viz.gui",
               "tpu_vo_torch.utils.profiling", "tpu_vo_torch.geometry.conventions",
               "tpu_vo_torch.tools.make_synthetic_dataset",
               "tpu_vo_torch.tools.evaluate_trajectory"]

# The parallel modules, which replace tpu_vo/parallel (jax.distributed,
# jax.sharding, shard_map), and the tool that runs one rank of a world
PARALLEL_MODULES = ["tpu_vo_torch.parallel", "tpu_vo_torch.parallel.mesh",
                    "tpu_vo_torch.parallel.distributed", "tpu_vo_torch.parallel.sharding",
                    "tpu_vo_torch.tools.parallel_run"]

# The profiling tools, which replace tools/ scripts, their shared harness,
# and the modules that hold the phases and AoS helpers they time
PROFILING_MODULES = ["tpu_vo_torch.tools." + m for m in (
    "profile_rows", "profile_headline", "profile_features", "select_breakdown", "topk_micro",
    "profile_4k", "probe_4k_gap", "profile_pairs", "profile_ransac", "profile_5pt_micro",
    "profile_chain", "streamed_probe", "profile_batch8", "profile_batch8_flat")] + [
    "tpu_vo_torch.estimation.five_point", "tpu_vo_torch.estimation.ransac"]
# The accuracy diagnostics and A/B probes, which replace tools/ scripts, and
# their shared module; cv2 only inside their functions
DIAGNOSTIC_MODULES = ["tpu_vo_torch.tools." + m for m in (
    "diag_common", "harris_candidate_probe", "dk_iters_diag", "score_variants_diag",
    "pan_blur_pair_probe", "keepties_seed_sweep", "keepties_diag", "pan_harsh_ablation",
    "parity_matrix", "diagnose_ate", "extract_orb_pattern")]
# The port of bench.py, which imports jax; cv2 only inside reference_band's
# functions (--reference live)
BENCH_MODULES = ["tpu_vo_torch.tools.bench", "tpu_vo_torch.tools.reference_band",
                 "tpu_vo_torch.tools.io_bench"]
AOS_HELPERS = ("_mul11", "_mul21", "_nullspace_basis", "_constraint_matrix", "_gauss_jordan",
               "_action_polynomials", "_conv", "_det_poly", "_poly_roots",
               "_poly_backward_error", "_newton_real")


def test_port_imports_without_jax_or_tpu_vo():
    script = _BLOCKED_IMPORT.replace("AOS_HELPERS", repr(AOS_HELPERS))
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 20
    assert set(PROBE_MODULES) <= set(mods)
    assert set(STREAM_MODULES) <= set(mods)
    assert set(ACCURACY_MODULES) <= set(mods)
    assert set(INGEST_MODULES) <= set(mods)
    assert set(VIZ_MODULES) <= set(mods)
    assert set(PARALLEL_MODULES) <= set(mods)
    assert set(PROFILING_MODULES) <= set(mods)
    assert set(DIAGNOSTIC_MODULES) <= set(mods)
    assert set(BENCH_MODULES) <= set(mods)
