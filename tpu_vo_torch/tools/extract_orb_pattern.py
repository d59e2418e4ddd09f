"""Recover ORB's 256-pair rBRIEF pattern by probing cv2, and check the
port's copy of it (port of tools/extract_orb_pattern.py). Needs cv2: it
runs on the CPU's host, where cv2 is installed.

Descriptor bit b of a keypoint at angle 0 is [I_blur(p_2b) < I_blur(p_2b+1)]
for fixed integer offsets p. Each of 31 x 31 = 961 probe images holds one
bright pixel on black, or one dark pixel on white, inside the patch; the
blurred value at every offset under each probe is exactly predictable
from cv2.GaussianBlur of a single impulse. Each pair (first, second) has
a deterministic signature of 1,922 bits over the probes, and matching
cv2's observed signatures to the predicted ones names all 256 pairs.

Rows: `pairs_recovered`, `ambiguous` (bits two pairs could explain),
`equal_to_package_constant` (the recovery against features/_orb_pattern,
which is never written), `first_8_pairs`, `verification` and `pattern`
(the recovered PATTERN_X and PATTERN_Y: --out PATH writes them with the
other rows, and nothing else is written). The verification computes
descriptors of `trials` random 128x128 images with the port's own
pipeline on the device it is given (image/filters.gaussian_blur, then
features/brief.descriptor_bits with the package's pattern) and compares
them with cv2's: a differing bit is a pattern error unless cv2's two
blurred samples lie within 2 of each other (cv2's ORB blurs inside its
pyramid and can round a .5 the other way).

    python -m tpu_vo_torch.tools.extract_orb_pattern --device cpu [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_vo_torch.features import brief
from tpu_vo_torch.features._orb_pattern import PATTERN_X, PATTERN_Y
from tpu_vo_torch.image.filters import gaussian_blur
from tpu_vo_torch.tools import profile_rows

DEFAULTS = dict(trials=20)
R = 15          # search offsets in [-R, R]^2
CENTER = 64
IMG = 128


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("extract_orb_pattern needs cv2 (OpenCV's Python package), which "
                          "this host does not have") from e
    return cv2


def make_orb(cv2):
    return cv2.ORB_create(nfeatures=500, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
                          firstLevel=0, WTA_K=2, scoreType=cv2.ORB_HARRIS_SCORE, patchSize=31,
                          fastThreshold=10)


def recover(cv2):
    """(flat [(x, y)] * 512 in OpenCV's layout, ambiguous bits)."""
    orb = make_orb(cv2)
    kp = [cv2.KeyPoint(float(CENTER), float(CENTER), 31.0, 0.0, 100.0, 0, -1)]
    offsets = [(ox, oy) for oy in range(-R, R + 1) for ox in range(-R, R + 1)]
    n = len(offsets)

    # A bright pixel on black localizes the second point of a pair, a dark
    # pixel on white the first; cv2 itself gives the blurred responses.
    delta = np.zeros((IMG, IMG), dtype=np.uint8)
    delta[CENTER, CENTER] = 255
    D_b = cv2.GaussianBlur(delta, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101).astype(np.int32)
    delta_d = np.full((IMG, IMG), 255, dtype=np.uint8)
    delta_d[CENTER, CENTER] = 0
    D_d = cv2.GaussianBlur(delta_d, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101).astype(np.int32)

    # V[h, p]: the blurred intensity at offset p under probe h
    off = np.asarray(offsets)
    dx = off[None, :, 0] - off[:, None, 0]
    dy = off[None, :, 1] - off[:, None, 1]
    near = (np.abs(dx) <= 3) & (np.abs(dy) <= 3)
    V_b = np.where(near, D_b[CENTER + np.clip(dy, -3, 3), CENTER + np.clip(dx, -3, 3)], 0)
    V_d = np.where(near, D_d[CENTER + np.clip(dy, -3, 3), CENTER + np.clip(dx, -3, 3)], 255)
    V = np.concatenate([V_b, V_d], axis=0).astype(np.int32)   # (2n, n)

    obs = np.zeros((2 * n, 256), dtype=bool)
    for hi, (hx, hy) in enumerate(offsets):
        for k, (bg, fg) in enumerate(((0, 255), (255, 0))):
            img = np.full((IMG, IMG), bg, dtype=np.uint8)
            img[CENTER + hy, CENTER + hx] = fg
            _, desc = orb.compute(img, kp)
            if desc is None or desc.shape != (1, 32):
                raise RuntimeError(f"cv2 gave no descriptor for probe {hi}")
            obs[k * n + hi] = np.unpackbits(desc[0], bitorder="little").astype(bool)

    sig_to_bit = {}
    for k, sig in enumerate(np.packbits(obs.T, axis=1)):
        sig_to_bit.setdefault(sig.tobytes(), []).append(k)
    pairs, ambiguous = [None] * 256, 0
    for i in range(n):
        packed = np.packbits((V[:, i:i + 1] < V).T, axis=1)   # (second j, signature)
        for j in range(n):
            for k in sig_to_bit.get(packed[j].tobytes(), ()):
                if pairs[k] is None:
                    pairs[k] = (offsets[i], offsets[j])
                else:
                    ambiguous += 1
    missing = [k for k in range(256) if pairs[k] is None]
    if missing:
        raise RuntimeError(f"unresolved bits: {missing}")
    return [p for pair in pairs for p in pair], ambiguous


def verify(cv2, trials: int, device) -> dict:
    """The port's descriptors at angle 0 against cv2's on random images."""
    orb = make_orb(cv2)
    kp = [cv2.KeyPoint(float(CENTER), float(CENTER), 31.0, 0.0, 100.0, 0, -1)]
    rng = np.random.default_rng(0)
    flips = errors = 0
    px, py = np.asarray(PATTERN_X), np.asarray(PATTERN_Y)
    for _ in range(trials):
        img = rng.integers(0, 256, size=(IMG, IMG), dtype=np.uint8)
        _, desc = orb.compute(img, kp)
        bits_cv = np.unpackbits(desc[0], bitorder="little").astype(bool)
        blurred = gaussian_blur(torch.from_numpy(img).to(device)[None].to(torch.float32))
        one = torch.tensor([[CENTER]], dtype=torch.int32, device=device)
        bits = brief.descriptor_bits(blurred, one, one,
                                     torch.zeros((1, 1), device=device))[0, 0].cpu().numpy()
        blur_cv = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101).astype(int)
        for k in np.nonzero(bits != bits_cv)[0]:
            v0 = blur_cv[CENTER + py[2 * k], CENTER + px[2 * k]]
            v1 = blur_cv[CENTER + py[2 * k + 1], CENTER + px[2 * k + 1]]
            if abs(v0 - v1) <= 2:
                flips += 1
            else:
                errors += 1
    return {"images": trials, "near_tie_flips": flips, "pattern_errors": errors,
            "device": str(device)}


def main(argv=None, device=None, **sizes) -> dict:
    o = profile_rows.options(argv, DEFAULTS, device, sizes, __doc__.split("\n\n")[0])
    cv2 = _cv2()
    rows = profile_rows.Rows("extract_orb_pattern", o)
    flat, ambiguous = recover(cv2)
    xs, ys = [p[0] for p in flat], [p[1] for p in flat]
    rows.add("pairs_recovered", len(flat) // 2)
    rows.add("ambiguous", ambiguous)
    rows.add("equal_to_package_constant", xs == list(PATTERN_X) and ys == list(PATTERN_Y))
    rows.add("first_8_pairs", [[flat[2 * k], flat[2 * k + 1]] for k in range(8)])
    rows.add("verification", verify(cv2, o.trials, o.device))
    rows.add("pattern", {"PATTERN_X": xs, "PATTERN_Y": ys})
    return rows.finish()


if __name__ == "__main__":
    main(sys.argv[1:])
