"""The port's accuracy diagnostics and A/B probes (tpu_vo_torch/tools:
harris_candidate_probe ... extract_orb_pattern) on the CPU at cut sizes.

Each tool runs through main(device="cpu", <cut sizes>), the tools that
read a committed leg with reference="cv2" (cv2 is installed here), prints
parseable JSON lines whose last is its result, writes nothing under
benchmarks/, and raises without a card when no device is named. The
port's helpers are held against the JAX tools' own module-level
functions (imported from their files; a JAX tool's main is never run:
it writes under benchmarks/), and the parts whose JAX logic lives inside
a main against the tpu_vo functions that the JAX tool composes, on one
shared float64 pool. The committed diagnostic legs hash as the port
renders them."""

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vo.estimation.five_point import five_point_candidates_batched as j_fpcb
from tpu_vo.estimation.recover_pose import recover_pose_from_essential as j_recover
from tpu_vo.geometry.epipolar import sampson_error as j_sampson
from tpu_vo_torch.configs import ORBConfig
from tpu_vo_torch.estimation.five_point import five_point_candidates_batched
from tpu_vo_torch.estimation.recover_pose import recover_pose_from_essential
from tpu_vo_torch.features import harris
from tpu_vo_torch.ops.patch import extract_patches
from tpu_vo_torch.tools import (diag_common, diagnose_ate, dk_iters_diag, extract_orb_pattern,
                                harris_candidate_probe, keepties_diag, keepties_seed_sweep,
                                pan_blur_pair_probe, pan_harsh_ablation, parity_matrix,
                                score_variants_diag)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCHMARKS = os.path.join(ROOT, "benchmarks")
SMALL = dict(width=160, height=120, features=100)
TWO_RES = dict(lo_width=160, lo_height=120, lo_features=100, lo_T=4, lo_pc=3,
               hi_width=200, hi_height=150, hi_features=150, hi_T=4, hi_pc=3)

# tool: (module, cut sizes, row names that must be there)
TOOLS = {
    "harris_candidate_probe": (
        harris_candidate_probe, dict(width=320, height=240, features=100, reps=1, iters=1),
        ["select_with_harris_ms", "select_no_harris_ms", "dense_harris_share_ms",
         "patches_winners_ms", "patches_candidates_ms", "center_harris_ms", "net_win_ms",
         "verdict", "select_with_harris_levels_ms", "select_no_harris_levels_ms",
         "dense_harris_share_levels_ms", "net_win_levels_ms", "verdict_levels"]),
    "dk_iters_diag": (dk_iters_diag, dict(T=4, hyps=4, fc=2, pc=3, reps=1, iters=1, **SMALL),
                      ["baseline_dk100", "dk_60", "dk_40", "aberth_40", "aberth_12"]),
    "score_variants_diag": (score_variants_diag, dict(T=3, hyps=8, seeds=(0,), **SMALL),
                            list(score_variants_diag.VARIANTS) + ["config"]),
    "pan_blur_pair_probe": (pan_blur_pair_probe, dict(T=3, **SMALL),
                            ["adaptive", "fixed0.5", "fixed1.0"]),
    "keepties_seed_sweep": (keepties_seed_sweep, dict(seeds=(0, 1), **TWO_RES),
                            ["200x150", "160x120"]),
    "keepties_diag": (keepties_diag, dict(reference="cv2", **TWO_RES), ["160x120", "200x150"]),
    "pan_harsh_ablation": (pan_harsh_ablation, dict(reference="cv2", frames=3, knobs=True,
                                                    **SMALL),
                           ["clean", "only_noise", "only_exposure", "only_blur", "only_jpeg",
                            "harsh_all", "blur_sigma1.5", "blur_fast5_sigma1.5"]),
    "parity_matrix": (parity_matrix, dict(reference="cv2", seeds=2, device_fps=True),
                      ["pan_160x120", "pan_160x120.faithful", "pan_160x120.production"]),
    "diagnose_ate": (diagnose_ate, dict(reference="cv2", frames=3, width=160, height=120),
                     ["pair1", "pair2", "mean"]),
    "extract_orb_pattern": (extract_orb_pattern, dict(trials=2),
                            ["pairs_recovered", "ambiguous", "equal_to_package_constant",
                             "verification", "pattern"]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other test processes, and
    oversubscribed OpenMP pools turn each parallel op into a wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_hash(root):
    h = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                h[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return h


def _jax_tool(name):
    """A module of the JAX package's tools/ loaded from its file (tools/
    has no __init__.py); only its module-level functions are used."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# parity_matrix's scene table cut to one small scene of its own kind
SMALL_SCENES = [("pan_160x120", "pan", 160, 120, 4, 100)]


@pytest.fixture
def small_scenes(monkeypatch):
    monkeypatch.setattr(parity_matrix, "SCENES", SMALL_SCENES)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_cpu(name, tmp_path, small_scenes):
    mod, cut, names = TOOLS[name]
    before = _tree_hash(BENCHMARKS)
    buf = io.StringIO()
    out = tmp_path / "rows.json"
    with contextlib.redirect_stdout(buf):
        obj = mod.main(device="cpu", out=str(out), **cut)
    lines = buf.getvalue().strip().splitlines()
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(obj))
    assert json.loads(out.read_text()) == last
    assert last["tool"] == name and last["card"] == "cpu"
    for n in names:
        assert n in last["rows"], n
    for line in lines[:-1]:
        row = json.loads(line)
        assert row["tool"] == name and row["card"] == "cpu"
        for key in ("ms", "device_fps"):
            if isinstance(row.get(key), (int, float)):
                pytest.fail(f"{row['row']}: a device figure from a CPU run")
    assert _tree_hash(BENCHMARKS) == before
    if name == "extract_orb_pattern":
        assert last["rows"]["equal_to_package_constant"] is True
        assert last["rows"]["verification"]["pattern_errors"] == 0
    if name == "diagnose_ate":
        assert all(isinstance(last["rows"]["pair1"][s], list) for s in "ABCD")


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_raises_without_a_card(name, monkeypatch, small_scenes):
    mod, cut, _ = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(**cut)


def test_score_variants_diag_takes_the_jax_tools_frames_flag():
    """--frames, as tools/score_variants_diag.py parses it (:202); T= still
    names the frames as a size (the JAX tool's main's name)."""
    argv = ["--frames", "2", "--width", "160", "--height", "120", "--features", "100",
            "--hyps", "8", "--seeds", "0", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        a = score_variants_diag.main(argv)
        b = score_variants_diag.main(argv[2:], T=2)
    assert a["sizes"]["frames"] == b["sizes"]["frames"] == 2
    assert a["rows"]["config"]["T"] == 2 and a["rows"] == b["rows"]
    assert len(a["rows"]["count"]["rot"]) == 1


def test_diagnose_ate_crosses_need_cv2_and_the_cpu(monkeypatch):
    """C and D are the string row where cv2 does not import."""
    monkeypatch.setattr(diag_common, "cv2_available", lambda: False)
    with contextlib.redirect_stdout(io.StringIO()):
        obj = diagnose_ate.main(device="cpu", reference="cv2", frames=2, width=160, height=120)
    for row in ("pair1", "mean"):
        assert obj["rows"][row]["C"] == obj["rows"][row]["D"] == diag_common.NEEDS_CV2
    assert isinstance(obj["rows"]["pair1"]["B"], list)


def test_committed_reference_refuses_other_frames():
    """No committed leg holds a cut scene: reference='committed' raises."""
    with pytest.raises(ValueError, match="no committed leg"):
        with contextlib.redirect_stdout(io.StringIO()):
            pan_harsh_ablation.main(device="cpu", frames=3, **SMALL)


def test_pair_motion_inverts_the_reference_composition():
    """diag_common.pair_motion recovers (R, t direction) of each step a
    trajectory composed as utils/cv_reference.ReferenceVO composes it."""
    rng = np.random.default_rng(0)
    R_wc, t_wc = np.eye(3), np.zeros(3)
    Rs, ts, steps = [R_wc], [t_wc], []
    for _ in range(4):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        t = rng.normal(size=3)
        t_wc = t_wc + 0.3 * (R_wc @ (-R.T @ t))
        R_wc = R_wc @ R.T
        Rs.append(R_wc)
        ts.append(t_wc)
        steps.append((R, t))
    for i, (R, t) in enumerate(steps, 1):
        Rg, tg = diag_common.pair_motion(np.stack(ts), np.stack(Rs), i)
        np.testing.assert_allclose(Rg, R, atol=1e-12)
        np.testing.assert_allclose(tg / np.linalg.norm(tg), t / np.linalg.norm(t), atol=1e-12)
    assert diag_common.pair_motion(np.zeros((2, 3)), np.stack(Rs[:2]), 1)[1] is None


# ---- the port's helpers against the JAX tools' module-level functions


def test_center_harris_matches_the_jax_tool_and_harris_at():
    jt = _jax_tool("harris_candidate_probe")
    rng = np.random.default_rng(3)
    lvl = rng.integers(0, 256, (1, 90, 120)).astype(np.float32)
    ys = rng.integers(31, 90 - 31, 40).astype(np.int32)[None]
    xs = rng.integers(31, 120 - 31, 40).astype(np.int32)[None]
    raw = extract_patches(torch.from_numpy(lvl), torch.from_numpy(ys), torch.from_numpy(xs))[0]
    ours = harris_candidate_probe.center_harris_from_patches(raw).numpy()
    theirs = np.asarray(jt.center_harris_from_patches(jnp.asarray(raw.numpy())))
    assert theirs.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
    at = harris.harris_at(torch.from_numpy(lvl), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(ours, at[0].numpy(), rtol=1e-6, atol=0)
    assert harris_candidate_probe._pyramid_shapes(1241, 376) == jt._pyramid_shapes(1241, 376)


def test_kp_sets_match_the_jax_tool():
    """The JAX tool's kp_sets_ours runs tpu_vo's detect_and_compute op by op
    (bit-faithful; two levels keep it to seconds); kp_sets_cv2 both cv2."""
    jt = _jax_tool("keepties_diag")
    from tpu_vo.configs import ORBConfig as JORBConfig

    img = diag_common.scene("corridor", 4, 160, 120, 0)[0][0]
    for kt in (False, True):
        theirs, _ = jt.kp_sets_ours(img, JORBConfig(n_features=100, n_levels=2,
                                                    retain_best_keep_ties=kt))
        ours, _ = keepties_diag.kp_sets_ours(img, ORBConfig(n_features=100, n_levels=2,
                                                            retain_best_keep_ties=kt))
        assert len(ours) == 100 and ours == theirs
    assert keepties_diag.kp_sets_cv2(img, 100) == jt.kp_sets_cv2(img, 100)


def test_variant_cfg_and_make_scene_match_the_jax_tool():
    jt = _jax_tool("parity_matrix")
    for variant in ("faithful", "production"):
        a = dataclasses.asdict(jt.variant_cfg(variant, 320, 240, 1200))
        b = dataclasses.asdict(parity_matrix.variant_cfg(variant, 320, 240, 1200))
        assert a == b, variant
    assert [s[:1] + s[2:] for s in jt.SCENES] == [s[:1] + s[2:] for s in parity_matrix.SCENES]
    for kind in ("corridor", "pan"):
        fa, Ra, ta, Ka = jt.make_scene(kind, 3, 160, 120)
        fb, Rb, tb, Kb = parity_matrix.make_scene(kind, 3, 160, 120)
        for x, y in zip(fa, fb):
            assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
        np.testing.assert_array_equal(np.stack(Ra), np.stack(Rb))
        np.testing.assert_array_equal(np.stack(ta), np.stack(tb))
        np.testing.assert_array_equal(Ka, Kb)


# ---- the logic inside the JAX tools' mains, on a shared float64 pool


@pytest.fixture(scope="module")
def pool():
    """A two-view scene in float64: 120 matches (30 outliers, 20 masked
    off), 48 five-point samples of the inliers (the variants do not
    all pick the same winner)."""
    rng = np.random.default_rng(7)
    n = 120
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 9, n)]
    ang = 0.05
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.3, 0.02, 0.1])
    x1 = X[:, :2] / X[:, 2:]
    Y = X @ R.T + t
    x2 = Y[:, :2] / Y[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    x2[:30] += rng.uniform(-0.2, 0.2, (30, 2))
    mask = np.ones(n, bool)
    mask[-20:] = False
    idx = np.stack([rng.choice(np.arange(30, n - 20), 5, replace=False) for _ in range(48)])
    return x1, x2, mask, idx, R, t


def test_score_variant_winners_match_the_jax_composition(pool):
    """score_variants_diag.winners and the winners' poses against the JAX
    tool's main: tpu_vo's sampson_error per hypothesis, its ranks, the
    adaptive sigma from jnp.nanmedian, recover_pose_from_essential."""
    x1, x2, mask, idx, R, t = pool
    Es, vm = five_point_candidates_batched(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]))
    Es, vm = Es.reshape(-1, 3, 3), vm.reshape(-1)
    thr_sq = (2.0 / 640.0) ** 2
    got, inls = score_variants_diag.winners(Es, vm, torch.from_numpy(x1), torch.from_numpy(x2),
                                            torch.from_numpy(mask), thr_sq)

    # the JAX tool's main (tools/score_variants_diag.py:76-156), in float64
    jE, jx1, jx2, jm = (jnp.asarray(a) for a in (Es.numpy(), x1, x2, mask))
    half_sq, tight_sq = thr_sq * 0.25, thr_sq * 0.0625

    def per_E(E):
        err = j_sampson(E, jx1, jx2)
        err = jnp.where(jnp.isfinite(err), err, jnp.inf)
        inl = (err < thr_sq) & jm
        return (inl, jnp.sum(inl), jnp.sum(jnp.where(jm, jnp.minimum(err, thr_sq), 0.0)),
                jnp.sum(jnp.where(jm, jnp.minimum(err, half_sq), 0.0)),
                jnp.sum(jnp.where(jm, jnp.minimum(err, tight_sq), 0.0)))

    j_inls, cnts, broads, halfs, tights = jax.vmap(per_E)(jE)
    cnts_f, b, h, tt = (np.asarray(a, np.float64) for a in (cnts, broads, halfs, tights))
    ladder = b / thr_sq + h / half_sq + tt / tight_sq
    N = mask.shape[0]
    ranks = {"count": cnts_f, "msac1": -b, "msac1n": -b / np.maximum(cnts_f, 1),
             "msac05n": -h / np.maximum(cnts_f, 1), "msac025n": -tt / np.maximum(cnts_f, 1),
             "ladder": -ladder, "laddern": -ladder / np.maximum(cnts_f, 1),
             "lex": cnts_f - tt / (tight_sq * N)}
    vm_np = vm.numpy()
    w05 = int(np.argmax(np.where(vm_np, ranks["msac05n"], -np.inf)))
    err = j_sampson(jE[w05], jx1, jx2)
    med = float(jnp.nanmedian(jnp.where(j_inls[w05], err, jnp.nan)))
    s_sq = float(np.clip(9.0 * med, 0.25 * thr_sq, thr_sq))
    al = np.asarray(jax.vmap(lambda E: jnp.sum(jnp.where(jm, jnp.minimum(
        jnp.where(jnp.isfinite(e := j_sampson(E, jx1, jx2)), e, jnp.inf),
        jnp.float32(s_sq)), 0.0)))(jE), np.float64)
    ranks["adapt"] = -al / np.maximum(cnts_f, 1)
    want = {v: int(np.argmax(np.where(vm_np, ranks[v], -np.inf)))
            for v in score_variants_diag.VARIANTS}
    assert got == want
    assert len(set(want.values())) >= 2
    np.testing.assert_array_equal(inls.numpy(), np.asarray(j_inls))

    b_idx = torch.tensor([got[v] for v in score_variants_diag.VARIANTS])
    k = len(b_idx)
    rec = recover_pose_from_essential(Es[b_idx], torch.from_numpy(x1).expand(k, -1, -1),
                                      torch.from_numpy(x2).expand(k, -1, -1), inls[b_idx], 50.0)
    for j, w in enumerate(b_idx.tolist()):
        jr = j_recover(jE[w], jx1, jx2, j_inls[w], 50.0)
        np.testing.assert_allclose(rec.R[j].numpy(), np.asarray(jr.R), atol=1e-9)
        np.testing.assert_allclose(rec.t[j].numpy(), np.asarray(jr.t), atol=1e-9)
    assert diag_common.rot_err_deg(rec.R[b_idx.tolist().index(got["count"])].numpy(), R) < 1.0


def test_root_budgets_match_tpu_vo_candidate_sets(pool):
    """dk_iters_diag's candidate sets at each budget equal tpu_vo's
    five_point_candidates_batched at that budget (float64), by the tool's
    set match; and its lost/spurious counts against the baseline agree."""
    x1, x2, _, idx, _, _ = pool
    s1, s2 = x1[idx], x2[idx]
    ref = [np.asarray(a) for a in j_fpcb(jnp.asarray(s1), jnp.asarray(s2), dk_iters=100,
                                         root_method="dk")]
    for method, it in (("dk", 100), ("dk", 40), ("aberth", 24), ("aberth", 12)):
        Es, v = (a.numpy() for a in five_point_candidates_batched(
            torch.from_numpy(s1), torch.from_numpy(s2), dk_iters=it, root_method=method))
        jE, jv = (np.asarray(a) for a in j_fpcb(jnp.asarray(s1), jnp.asarray(s2), dk_iters=it,
                                                root_method=method))
        assert (int(v.sum()), int(jv.sum())) == (int(jv.sum()), int(v.sum()))
        assert dk_iters_diag.set_match(Es, v, jE, jv, tol=1e-6) == (0, 0), (method, it)
        assert (dk_iters_diag.set_match(Es, v, *ref)
                == dk_iters_diag.set_match(jE, jv, *ref)), (method, it)
    assert int(ref[1].sum()) >= len(idx)
