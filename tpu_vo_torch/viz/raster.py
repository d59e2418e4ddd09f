"""A small rasteriser on numpy arrays: the three primitives the viewer,
the keypoint overlay and the epipolar tool draw, after the algorithms of
PIL's ImageDraw (Draw.c), which tpu_vo draws with:

  line_pixels     ImageDraw.line: width 1 by Bresenham between the
                  truncated integer end points, both ends drawn; wider
                  lines as ImagingDrawWideLine's quadrilateral, filled
                  by polygon_generic's scanline (float32 edge crossings,
                  ROUND_UP on the left, ROUND_DOWN on the right);
  ellipse_pixels  ImageDraw.ellipse on the truncated integer box: the
                  quarter-ellipse walk in doubled coordinates, mirrored
                  into four quadrants; its points are the width-1
                  outline, and each row's outermost point bounds the fill.

Every function works on all primitives of a kind at once and returns
(primitive index, row, column) of the pixels inside the image; paint()
then writes them in the order given, a later primitive over an earlier
one, as PIL's painter's order leaves them. PIL's polygon fill also
"connects discontiguous corners" of some polygons; that adjustment is
left out, so a wide line can differ from PIL's by a pixel at a corner.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Pixels = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (primitive, row, column)


def _empty() -> Pixels:
    z = np.zeros(0, np.int64)
    return z, z, z


def _trunc(v) -> np.ndarray:
    """C's (int) cast of doubles."""
    return np.trunc(np.asarray(v, np.float64)).astype(np.int64)


def _spans(prim, row, x0, x1, h: int, w: int) -> Pixels:
    """Pixels of horizontal spans [x0, x1] (inclusive) on rows, clipped
    to rows [0, h) and columns [0, w) as Draw.c's hline clips them."""
    x0, x1 = np.maximum(x0, 0), np.minimum(x1, w - 1)
    keep = (x0 <= x1) & (row >= 0) & (row < h)
    prim, row, x0, x1 = prim[keep], row[keep], x0[keep], x1[keep]
    n = x1 - x0 + 1
    idx = np.repeat(np.arange(n.size), n)
    col = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n) + x0[idx]
    return prim[idx], row[idx], col


def _bresenham(p0, q0, p1, q1, hp: int, hq: int) -> Pixels:
    """Bresenham points from (p0, q0) to (p1, q1), both ends included,
    where p is the major axis (|p1 - p0| >= |q1 - q0|): step i is at
    p0 + sp i, q0 + sq floor((2 dq i + dp) / (2 dp)). Only the steps
    whose p lies in [0, hp) and whose q may lie in [0, hq) are made."""
    dp, dq = np.abs(p1 - p0), np.abs(q1 - q0)
    sp, sq = np.where(p1 >= p0, 1, -1), np.where(q1 >= q0, 1, -1)
    # steps whose major coordinate is inside
    lo = np.where(sp > 0, -p0, p0 - (hp - 1))
    hi = np.where(sp > 0, hp - 1 - p0, p0)
    lo, hi = np.maximum(lo, 0), np.minimum(hi, dp)
    # and whose minor coordinate can be: k = floor((2 dq i + dp) / (2 dp)) in [kmin, kmax]
    kmin = np.where(sq > 0, -q0, q0 - (hq - 1))
    kmax = np.where(sq > 0, hq - 1 - q0, q0)
    pos = dq > 0
    den = np.where(pos, 2 * dq, 1)
    ilo = np.where(pos, (2 * dp * kmin - dp) // den - 1, np.where(kmin <= 0, 0, dp + 1))
    ihi = np.where(pos, -((-(2 * dp * (kmax + 1) - dp)) // den) + 1,
                   np.where(kmax >= 0, dp, -1))
    lo, hi = np.maximum(lo, ilo), np.minimum(hi, ihi)
    n = np.maximum(hi - lo + 1, 0)
    seg = np.repeat(np.arange(n.size), n)
    i = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n) + lo[seg]
    k = (2 * dq[seg] * i + dp[seg]) // (2 * dp[seg])
    p = p0[seg] + sp[seg] * i
    q = q0[seg] + sq[seg] * k
    keep = (q >= 0) & (q < hq) & (p >= 0) & (p < hp)
    return seg[keep], p[keep], q[keep]


def _thin_lines(x0, y0, x1, y1, h: int, w: int) -> Pixels:
    """Width-1 lines between integer end points."""
    xmaj = np.abs(x1 - x0) > np.abs(y1 - y0)
    a = np.flatnonzero(xmaj)
    b = np.flatnonzero(~xmaj)
    sa, xa, ya = _bresenham(x0[a], y0[a], x1[a], y1[a], w, h)
    sb, yb, xb = _bresenham(y0[b], x0[b], y1[b], x1[b], h, w)
    return (np.concatenate([a[sa], b[sb]]), np.concatenate([ya, yb]),
            np.concatenate([xa, xb]))


def _round_up(f):
    return np.where(f >= 0, np.floor(f + 0.5), -np.floor(np.abs(f) + 0.5)).astype(np.int64)


def _round_down(f):
    return np.where(f >= 0, np.ceil(f - 0.5), -np.ceil(np.abs(f) - 0.5)).astype(np.int64)


def _quads(vx, vy, h: int, w: int) -> Pixels:
    """Filled quadrilaterals (Q, 4) integer vertices, by polygon_generic's
    scanline: horizontal edges drawn as spans, every other edge crossed
    at each row in float32, a crossing at an edge's lower end counted
    twice (except on the last row), crossings sorted and paired."""
    q = vx.shape[0]
    ex0, ey0 = vx, vy
    ex1, ey1 = np.roll(vx, -1, 1), np.roll(vy, -1, 1)
    eymin, eymax = np.minimum(ey0, ey1), np.maximum(ey0, ey1)
    flat = eymin == eymax
    fi, fe = np.nonzero(flat)
    parts = [_spans(fi, ey0[fi, fe], np.minimum(ex0, ex1)[fi, fe],
                    np.maximum(ex0, ex1)[fi, fe], h, w)]
    with np.errstate(divide="ignore", invalid="ignore"):
        edx = np.where(flat, 0, (ex1 - ex0).astype(np.float32)
                       / np.where(flat, 1, ey1 - ey0).astype(np.float32)).astype(np.float32)
    ymin = np.maximum(vy.min(1), 0)
    ymax = np.minimum(vy.max(1), h)
    n = np.maximum(ymax - ymin + 1, 0)
    poly = np.repeat(np.arange(q), n)
    row = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n) + ymin[poly]
    if row.size:
        r = row[:, None]
        live = (~flat[poly]) & (r >= eymin[poly]) & (r <= eymax[poly])
        x = ((r - ey0[poly]).astype(np.float32) * edx[poly]
             + ex0[poly].astype(np.float32)).astype(np.float32)
        twice = live & (r == eymax[poly]) & (r < ymax[poly][:, None])
        xx = np.concatenate([np.where(live, x, np.inf), np.where(twice, x, np.inf)], 1)
        xx = np.sort(xx.astype(np.float32), 1)
        for k in range(0, xx.shape[1], 2):
            a, b = xx[:, k], xx[:, k + 1]
            ok = np.isfinite(b)
            xs = _round_up(np.where(ok, a, 0).astype(np.float32))
            xe = _round_down(np.where(ok, b, 0).astype(np.float32))
            sel = ok & (xe >= xs)
            parts.append(_spans(poly[sel], row[sel], xs[sel], xe[sel], h, w))
    return tuple(np.concatenate(c) for c in zip(*parts))


def line_pixels(xy: np.ndarray, widths, h: int, w: int) -> Pixels:
    """Pixels of lines xy (N, 4) = (x0, y0, x1, y1) of integer widths (N,)
    on an h x w image, as ImageDraw.line(xy, width=w) draws each."""
    xy = np.asarray(xy, np.float64).reshape(-1, 4)
    widths = np.broadcast_to(np.asarray(widths, np.int64), (xy.shape[0],))
    if xy.shape[0] == 0:
        return _empty()
    x0, y0, x1, y1 = (_trunc(xy[:, k]) for k in range(4))
    thin = np.flatnonzero(widths <= 1)
    wide = np.flatnonzero(widths > 1)
    parts = []
    s, r, c = _thin_lines(x0[thin], y0[thin], x1[thin], y1[thin], h, w)
    parts.append((thin[s], r, c))
    if wide.size:
        X0, Y0, X1, Y1 = x0[wide], y0[wide], x1[wide], y1[wide]
        dx, dy = X1 - X0, Y1 - Y0
        point = (dx == 0) & (dy == 0)
        pi = np.flatnonzero(point)
        inside = (X0[pi] >= 0) & (X0[pi] < w) & (Y0[pi] >= 0) & (Y0[pi] < h)
        parts.append((wide[pi[inside]], Y0[pi[inside]], X0[pi[inside]]))
        qi = np.flatnonzero(~point)
        X0, Y0, X1, Y1, dx, dy = X0[qi], Y0[qi], X1[qi], Y1[qi], dx[qi], dy[qi]
        big = np.hypot(dx, dy)
        small = (widths[wide][qi] - 1) / 2.0
        rmax = _round_up(small) / big
        rmin = _round_down(small) / big
        dxmin, dxmax = _round_down(rmin * dy), _round_down(rmax * dy)
        dymin, dymax = _round_down(rmin * dx), _round_down(rmax * dx)
        vx = np.stack([X0 - dxmin, X1 - dxmin, X1 + dxmax, X0 + dxmax], 1)
        vy = np.stack([Y0 + dymax, Y1 + dymax, Y1 - dymin, Y0 - dymin], 1)
        s, r, c = _quads(vx, vy, h, w)
        parts.append((wide[qi][s], r, c))
    return tuple(np.concatenate(c) for c in zip(*parts))


def ellipse_pixels(boxes: np.ndarray, fill: bool, h: int, w: int) -> Pixels:
    """Pixels of ellipses in boxes (N, 4) = (x0, y0, x1, y1), filled or as
    a width-1 outline, as ImageDraw.ellipse draws them: the box truncated
    to integers, a = x1 - x0, b = y1 - y0; in doubled coordinates the
    walk starts at (a, b % 2) and steps to whichever of (X, Y + 2),
    (X - 2, Y + 2), (X - 2, Y) lies nearest the curve
    |a^2 Y^2 + b^2 X^2 - a^2 b^2| (the last two only while X > 1),
    until (a % 2, b)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    x0, y0, x1, y1 = (_trunc(boxes[:, k]) for k in range(4))
    a, b = x1 - x0, y1 - y0
    # a fill's walk has width a + b, and a width below 1 draws nothing
    ok = np.flatnonzero((a >= 0) & (b >= 0) & ((a + b >= 1) | (not fill)))
    if ok.size == 0:
        return _empty()
    x0, y0, a, b = x0[ok], y0[ok], a[ok], b[ok]
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2
    cx, cy = a.copy(), b % 2
    ex, ey = a % 2, b
    active = np.ones(ok.size, bool)
    steps = []
    while active.any():
        steps.append((np.flatnonzero(active), cx[active], cy[active]))
        done = active & (cx == ex) & (cy == ey)
        active &= ~done
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        X, Y = cx[idx], cy[idx]
        A2, B2, AB = a2[idx], b2[idx], a2b2[idx]

        def delta(px, py):
            return np.abs(A2 * py * py + B2 * px * px - AB)

        nx, ny = X.copy(), Y + 2
        nd = delta(nx, ny)
        more = X > 1
        d2 = delta(X - 2, Y + 2)
        take = more & (nd > d2)
        nx, ny, nd = np.where(take, X - 2, nx), np.where(take, Y + 2, ny), np.where(take, d2, nd)
        d3 = delta(X - 2, Y)
        take = more & (nd > d3)
        nx, ny = np.where(take, X - 2, nx), np.where(take, Y, ny)
        cx[idx], cy[idx] = nx, ny
    e = np.concatenate([s[0] for s in steps])
    X = np.concatenate([s[1] for s in steps])
    Y = np.concatenate([s[2] for s in steps])
    if fill:
        # each row's first point is its outermost: span [-X, X]
        first = np.ones(e.size, bool)
        order = np.lexsort((-X, Y, e))
        e, X, Y = e[order], X[order], Y[order]
        first[1:] = (e[1:] != e[:-1]) | (Y[1:] != Y[:-1])
        e, X, Y = e[first], X[first], Y[first]
        e, Y = np.concatenate([e, e]), np.concatenate([Y, -Y])
        X = np.concatenate([X, X])
        rows = y0[e] + (Y + b[e]) // 2
        s, r, c = _spans(e, rows, x0[e] + (a[e] - X) // 2, x0[e] + (a[e] + X) // 2, h, w)
        return ok[s], r, c
    e = np.concatenate([e, e, e, e])
    X = np.concatenate([X, -X, X, -X])
    Y = np.concatenate([Y, Y, -Y, -Y])
    rows = y0[e] + (Y + b[e]) // 2
    cols = x0[e] + (X + a[e]) // 2
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return ok[e[keep]], rows[keep], cols[keep]


def paint(img: np.ndarray, order: np.ndarray, rows: np.ndarray, cols: np.ndarray,
          colors: np.ndarray) -> np.ndarray:
    """Write colors (N, C) at (rows, cols) of img (H, W, C) in place, each
    pixel taking the color of its largest `order` (the last primitive
    drawn over it)."""
    if rows.size == 0:
        return img
    flat = rows * img.shape[1] + cols
    srt = np.lexsort((order, flat))
    flat, colors = flat[srt], np.asarray(colors)[srt]
    last = np.ones(flat.size, bool)
    last[:-1] = flat[1:] != flat[:-1]
    img.reshape(-1, img.shape[2])[flat[last]] = colors[last]
    return img
