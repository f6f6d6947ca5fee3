"""Device ms a job of the kernels launched inside the port's span
``kernel.householder_qr`` (``ops/cuda/qr.py``: the blocked float64
Householder QR that orthonormalises each head's subspace block, seven calls
a layer) in the traced job; None where the program has no such span."""


def read(ctx):
    t = ctx.trace
    jobs = t.span_count("pca.finalize")
    if not jobs or not t.span_count("kernel.householder_qr"):
        return None
    return (t.device_ms("kernel.householder_qr") or 0.0) / jobs
