"""The benchmark's reference: the plain PyTorch code of tpu_vo_torch's
main path, frozen here as it stood when the benchmark was written, with
the kernels B1 and B2 replaced by their plain versions (`select`,
`patch`). It imports nothing of tpu_vo_torch, so a later change to the
program cannot move the yardstick it is held to. `pipeline` runs it as
the program's batched entries batch their work.
"""
