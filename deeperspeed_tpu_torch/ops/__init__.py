"""The port's ops: the hand-written Hopper kernels (`ops.hopper`), the
optimizers, the transformer layer and sparse attention."""


def dispatch_report():
    """The kernel design each wrapper last ran, as one dict (the JAX
    package's `ops.dispatch_report`, with its keys). The telemetry
    capture exports and the environment report carry it: WHICH design
    produced a number matters as much as the number.

    ``flash``: {"fwd", "bwd"}, each "mma" (the tensor-core kernels),
    "fma" (the FMA tile steps) or "plain" (the plain version);
    ``decode_attention``: {"decode": "cluster" / "single" / "plain",
    "decode_kv": the pool dtype, "int8" for quantized pools};
    ``quant_matmul``: {"quant_matmul": "wgmma" / "fma" / "plain"}. A
    kernel that has not run yet gives an empty dict."""
    from .hopper import decode_attention, flash_attention, quant_matmul
    return {"flash": dict(flash_attention.LAST_DESIGN),
            "decode_attention": dict(decode_attention.LAST_DESIGN),
            "quant_matmul": dict(quant_matmul.LAST_DESIGN)}


__all__ = ["dispatch_report"]
