"""glue_device_ms: device milliseconds a request of kernels that are not
the program's own CUDA kernels (PyTorch's operators between them)."""

from harness.trace import kernel_matches


def read(ctx):
    t = ctx.trace
    glue = sum(e - s for name, s, e in t.kernels
               if not any(kernel_matches(name, k) for k in ctx.port_kernels))
    return glue * 1e3 / t.requests
