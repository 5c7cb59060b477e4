"""The packed FFN's decode kernel (``packed_matmul``'s ``gemv_kernel``)
against its roofline: the least time of a decode step's packed products at
M = lanes (``work.flops.packed_ffn_products``: codes, scales, x and y
bytes at 3.35 TB/s, or FLOPs at 989 TFLOP/s), times the decode steps the
profiled launches make, over the launches' measured time."""

from work.flops import least_seconds, packed_ffn_products


def read(run):
    t, c = run.trace, run.config
    if t is None or not int(c.get("w_bits", 0)):
        return None
    n, ns = t.launches("gemv_kernel"), t.total_ns("gemv_kernel")
    if not n or not ns:
        return None
    products = packed_ffn_products(c, int(c["engine"]["lanes"]))
    step_s = sum(least_seconds(p["bytes"], p["flops"]) for p in products)
    return 100.0 * step_s * (n / len(products)) / (ns / 1e9)
