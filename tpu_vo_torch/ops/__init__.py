"""The port's hand-written CUDA kernels and their plain PyTorch versions.

select_maps (kernel B1, csrc/select.cu) and extract_patches (kernel B2,
csrc/patch.cu) dispatch on the input tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
"""
