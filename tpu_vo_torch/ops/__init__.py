"""The port's hand-written CUDA kernels and their plain PyTorch versions.

select_maps (kernel B1, csrc/select.cu), extract_patches (kernel B2,
csrc/patch.cu), fast_margin (kernel B3, csrc/fast.cu) and the patch-slots
probe's band_windows, phase_windows_mxu and phase_windows_roll (kernels
P1, P2 and P3, csrc/patch_probe.cu) dispatch on the input tensor's device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. So does describe_windows
(csrc/describe.cu: the angles, blur and steered rBRIEF bits of B2's
windows).
"""
