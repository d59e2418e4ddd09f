"""Project-wide geometry conventions (doc-only, like geometry_conventions.h;
port of tpu_vo/geometry/conventions.py).

Mirrors the reference's geometry_conventions.h:1-29 — the math doctrine
every module in this package follows:

Pixels and points
  - Pixel coordinates are 0-based; a 2D point is used homogeneously as
    x = [u, v, 1]^T. (The epipolar viewer converts to MATLAB 1-based with
    the shift matrix T; see tpu_vo_torch.geometry.epipolar.)

Two-view geometry
  - Correspondences satisfy x2^T F x1 = 0 with x1 in the previous frame
    and x2 in the current frame (OpenCV convention).
  - The essential matrix acts on normalized coordinates x_hat = K^{-1} x:
    E = [t]_x R, and F = K^{-T} E K^{-1}.
  - recoverPose-style relative motion maps camera-1 coordinates into
    camera 2: X_2 = R X_1 + t.

Poses
  - A Pose stores the camera->world transform T_wc = [R_wc | t_wc]:
    X_w = R_wc X_c + t_wc; camera center C_w = t_wc.
  - World->camera (MVG extrinsic form): R_cw = R_wc^T,
    t_cw = -R_wc^T t_wc.
  - Chaining: T_w_c2 = T_w_c1 * T_c1_c2, where T_c1_c2 is the *inverse*
    of the recovered relative motion, with the translation scaled by the
    fixed visualization factor (monocular scale is unobservable).

Images
  - Grayscale is BT.601 (cv2-exact integer arithmetic); image arrays are
    (H, W) with row = y down, column = x right.
"""
