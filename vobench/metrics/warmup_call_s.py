"""Host time of the process's first vo.call, the harness's warm-up call
(the kernels' library, cuBLAS and lazy CUDA modules, the program's
constant caches), in s; read where the program recorded spans in the
traced window."""

from vobench.metrics import _spans


def read(ctx):
    v = _spans.view(ctx)
    first = v.first_call() if v is not None else None
    if first is None:
        return None
    return (first.end_ns - first.start_ns) / 1e9
