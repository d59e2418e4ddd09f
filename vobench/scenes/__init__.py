"""Scenes drawn on the card from a seed, one module per scene kind.

Each module has `make(seed, n_frames, width, height, device, **params)`
returning (frames (n, H, W) uint8, R_wc (n, 3, 3), t_wc (n, 3)): the
frames and the camera->world poses they were drawn from, in closed form.
A configuration names its kind and parameters (`scene` in its file).
"""
